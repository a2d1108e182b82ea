"""The packed and raw readbacks' kernels (ops/mesh_cuda.py: csrc/marching.cu's
mesh emission, csrc/mesh.cu's weld and pack).

On the CPU: the kernels' arithmetic (csrc/mesh.cuh with marching.cuh and
radix_sort.cuh) built for the host with g++ -ffp-contract=off, with host
loops that run the kernels as the card does: the scan's list (tile, cell,
vertex and index bases) by a plain loop over the tiles; the mesh emission
a listed tile a CTA (its corners staged a row a thread, a thread's four
cells counted, one scan of the tile's counts, then batches of 128
occupied cells whose vertices and triangles go a thread each through two
owner maps: every position and index word written once, checked; 4-byte
compact keys up to 32 bits); the weld's radix sort over the keys'
top digits tile by tile (reading the keys at that width, 32- or 64-bit
keys between passes, the look-back in both orders); the group kernel a
tile of 2,048 top-sorted keys a CTA (its groups, the last one's overhang,
the capacity check, each group's local digits as a warp ranks them, the
run starts and the look-back in both orders); the pack a thread a
welded vertex and a triangle. Held bit for bit to the plain chain
`marching.generate_mesh` -> `weld.weld` -> `block.pack_readback` (the
unwelded vertices, keys and triangles; the welded vertices, keys,
triangles and counts; the image in every index mode and both vertex-word
widths) on fields made from a numpy seed: a sphere, region edges that are
not multiples of 8, a block of 10 tiles an axis, dense noise, exact 0.0
and -0.0 corners, subnormal differences, an origin near the keys' 21-bit
limit, the tiled rule's candidate tiles (marching.TILED_ABOVE lowered),
a block with no surface and one-cell blocks whose vertices all lie on the
region's faces, a planar wall (every vertex on one kz, groups exactly at
the group kernel's capacity), dense tiles (every cell occupied with 13
vertices and 12 triangles) at 256^3 and at 77^3 (rows not 16-byte
aligned), keys of 31 and 34 bits (either side of the 4-byte switch);
and to the JAX package's
`generate(emit="mesh")`, `weld` and `_pack_readback` on two of them. The
weld alone on made keys against the plain weld: every key a 4-fold
duplicate, groups that straddle tiles, a group at the capacity, and one
past it (counted, not welded). Also: the weld's plan (passes, free bits,
capacity) at every key width against the largest group a block's edge
midpoints can form, the compact key's order and
equalities against the global (hi, lo) keys at origins near 2^20, the
header's new tables, the weld's scratch sizes, the wrappers on CPU tensors
(the plain chain, no launch) and the block step's packed and raw
branches there. On the card (marker `cuda`): the kernels bit for bit the
plain chain at 256^3 and 512^3 (and with 31- to 43-bit keys, on a planar
wall and on dense tiles at 256^3 and 301^3), on two streams at once, a
group at the capacity bit for bit and
one past it raising, their launches and syncs, and the memory estimate
above a stage's peak.

Only the JAX comparison imports jax, inside its tests: the card's machine
has none (and runs the `cuda` tests alone), and there an installed package
named `tests` also shadows `tests.oracle`.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mlsgpu_tpu_torch.ops import (block, launches, marching, marching_cuda,
                                  mesh_cuda, tables, weld)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mlsgpu_tpu_torch", "csrc")

#: The mesh readbacks' kernels' names in ops/launches.py.
MESH = ("march_classify", "march_scan", "march_emit_mesh",
        "weld_sort_histogram", "weld_sort_pass", "weld_group",
        "pack_readback")
#: Every packed layout: (index mode, vertex words).
FORMATS = [(mode, vw) for mode in mesh_cuda.INDEX_MODES for vw in (3, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- fields -------------------------------------------------------------------

def sphere_field(b, center, radius):
    g = np.arange(b, dtype=np.float64)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    d = np.sqrt((xx - center[0]) ** 2 + (yy - center[1]) ** 2
                + (zz - center[2]) ** 2) - radius
    return d.astype(np.float32)


def field_case(name):
    """(field (B, B, B) f32 [z, y, x], region (x, y, z) cells, cell origin
    (x, y, z)) of a test case, from a numpy seed."""
    rng = np.random.default_rng(47)
    if name == "sphere":
        return sphere_field(32, (15.5, 15.3, 15.8), 9.0), (31, 31, 31), \
            (0, 0, 0)
    if name == "open":
        # the surface leaves the region: external vertices on its faces
        f = sphere_field(40, (30.0, 12.0, 20.0), 14.0)
        f[rng.random(f.shape) < 0.01] = np.nan
        return f, (35, 39, 30), (64, 32, 8)
    if name == "region_edges":
        f = sphere_field(20, (12.0, 6.0, 9.5), 7.0)
        f[rng.random(f.shape) < 0.02] = np.nan
        return f, (13, 19, 7), (3, 5, 7)
    if name == "wide":
        # 10 tiles an axis
        f = sphere_field(76, (40.0, 33.0, 37.0), 29.0)
        f[rng.random(f.shape) < 0.01] = np.nan
        return f, (75, 70, 61), (1000, 200, 30)
    if name == "noise":
        # a dense random field: most cells cut, many vertices a cell
        f = rng.normal(size=(40, 40, 40)).astype(np.float32)
        f[rng.random(f.shape) < 0.05] = np.nan
        return f, (39, 33, 38), (8, 16, 24)
    if name == "zeros":
        # exact 0.0 and -0.0 beside small values of both signs
        vals = np.float32([0.0, -0.0, 0.5, -0.5, 1e-3, -1e-3, 2.0, -2.0])
        return rng.choice(vals, size=(16, 16, 16)), (15, 14, 13), (5, 6, 7)
    if name == "subnormal":
        tiny = np.float32([1e-45, 3e-45, 1e-42, 7e-41, 1.1754942e-38,
                           1e-38, 0.0])
        big = np.float32([1.0, 3e38, 1e-30])
        mags = np.concatenate([tiny] * 3 + [big])
        f = rng.choice(mags, size=(24, 24, 24)) * rng.choice(
            np.float32([-1.0, 1.0]), size=(24, 24, 24))
        return f.astype(np.float32), (23, 23, 23), (0, 0, 0)
    if name == "far_origin":
        # the doubled global coordinates up to 2^21 - 2: the keys' last bits
        f = sphere_field(37, (18.0, 16.5, 19.2), 12.5)
        o = (1 << 20) - 37
        return f, (36, 36, 36), (o, o - 5, o)
    if name == "wall":
        # a planar wall: every vertex on one kz, each key group (ext, kz,
        # ky, kx >> 6 at 22-bit keys) up to its capacity less the region's
        # faces
        g = np.arange(40, dtype=np.float32)
        f = np.broadcast_to((g - 20.37)[:, None, None], (40, 40, 40))
        return np.ascontiguousarray(f), (39, 39, 39), (0, 0, 0)
    if name == "no_surface":
        return (rng.random((16, 16, 16)) + 0.5).astype(np.float32), \
            (15, 15, 15), (0, 0, 0)
    if name in ("dense", "dense_odd"):
        return dense_field(256 if name == "dense" else 77, rng)
    raise KeyError(name)


def dense_field(b, rng):
    """A (b, b, b) field of positive values but for blocks whose sign
    alternates corner by corner, each cell of them occupied with the
    most vertices and triangles a cell has (13 and 12): whole tiles of
    512 such cells (at 256^3: the tiles 1-2 along z, 2-3 along y, 5-6 along
    x, the next tile's cells beside them half cut), and at an odd b
    (unaligned corner rows) tiles cut by the field's end. Its region, its
    origin."""
    f = (0.5 + rng.random((b, b, b))).astype(np.float32)
    z, y, x = np.ogrid[:b, :b, :b]
    alt = np.where((x + y + z) % 2 == 0, 1.0, -1.0).astype(np.float32)
    boxes = [(slice(8, 25), slice(16, 33), slice(40, 57))]
    if b % 2:
        boxes.append((slice(b - 21, b), slice(b - 13, b), slice(b - 30, b)))
    for box in boxes:
        f[box] = np.abs(f[box]) * alt[box]
    return f, (b - 1, b - 1, b - 2), (3, 70, 1000)


def tile_sizes(chain):
    """The listed tiles' occupied cells, vertices and indices (from the
    scan's list and totals)."""
    t, rows = chain["totals"], chain["tile_list"].astype(np.int64)
    ends = [t["cells"], t["vertices"], t["indices"]]
    sizes = np.diff(np.vstack([rows[:, 1:], [ends]]), axis=0)
    return sizes[:, 0], sizes[:, 1], sizes[:, 2]


CASES = ("sphere", "open", "region_edges", "wide", "noise", "zeros",
         "subnormal", "far_origin", "wall", "no_surface")


# --- the kernels' arithmetic, built for the host ------------------------------

# The kernels' bodies as host loops over mesh.cuh: the scan's list by a
# loop over the tiles (what march_scan_kernel writes, which
# tests/test_torch_marching_cuda.py holds to its own emulation); the mesh
# emission a listed tile (a warp) at a time, its lanes in loops; the
# weld's sort and group kernel tile by tile, their look-backs in ticket
# order or from the last tile; the pack a thread at a time.
_HARNESS = r"""
#include <math.h>
#include <string.h>

#include <algorithm>
#include <vector>

#include "mesh.cuh"
#include "radix_sort.cuh"
#include "scan.cuh"

extern "C" int host_max_indices() { return MARCH_MAX_CELL_INDICES; }

extern "C" void host_mesh_tables(int* index, int* corners) {
  for (int c = 0; c < 256; ++c) {
    for (int i = 0; i < MARCH_MAX_CELL_INDICES; ++i)
      index[c * MARCH_MAX_CELL_INDICES + i] =
          mesh_index_vertex(&march_index_h[0][0], c, i);
    for (int j = 0; j < MARCH_MAX_CELL_VERTICES; ++j)
      corners[c * MARCH_MAX_CELL_VERTICES + j] =
          (int)mesh_vertex_corners(&march_vert_corners_h[0][0], c, j);
  }
}

extern "C" long long host_weld_scratch_words(long long n, int bits) {
  return mesh_weld_scratch_words(n, bits);
}

extern "C" long long host_weld_work_words(long long n, int bits) {
  return mesh_weld_work_words(n, bits);
}

extern "C" long long host_index_words(int mode, long long ni) {
  return mesh_index_words(mode, ni);
}

// mesh_keys for n doubled block-local coordinates (x, y, z) each.
extern "C" void host_keys(const int* k, long long n, int rx, int ry, int rz,
                          long long ox, long long oy, long long oz,
                          int axis_bits, unsigned* hi, unsigned* lo,
                          unsigned long long* sort) {
  const MeshFrame f{{2 * rx, 2 * ry, 2 * rz}, {2 * ox, 2 * oy, 2 * oz},
                    axis_bits};
  for (long long i = 0; i < n; ++i)
    mesh_keys(k + 3 * i, f, hi + i, lo + i, sort + i);
}

static float corner(const float* field, int b, int x, int y, int z) {
  return x < b && y < b && z < b ? field[((long long)z * b + y) * b + x] : NAN;
}

static int tiles_an_axis(int b) { return (b - 1 + MARCH_TILE - 1) / MARCH_TILE; }

// The scan's list (a row of tile, cell base, vertex base, index base for
// each tile with an occupied cell, in tile order) and totals (cells,
// vertices, indices, candidate tiles if count_candidates else 0, listed
// tiles) by a plain loop over the tiles' cells.
extern "C" void host_list(const float* field, int b, int rx, int ry, int rz,
                          int count_candidates, int* list,
                          long long* totals) {
  const int g = tiles_an_axis(b);
  long long cells = 0, vertices = 0, indices = 0, cand = 0, rows = 0;
  for (int t = 0; t < g * g * g; ++t) {
    const int tx = t % g, ty = t / g % g, tz = t / (g * g);
    long long c = 0, v = 0, i = 0;
    bool finite = false;
    for (int lz = 0; lz < MARCH_TILE; ++lz)
      for (int ly = 0; ly < MARCH_TILE; ++ly)
        for (int lx = 0; lx < MARCH_TILE; ++lx) {
          const int x = tx * MARCH_TILE + lx, y = ty * MARCH_TILE + ly,
                    z = tz * MARCH_TILE + lz;
          finite = finite || isfinite(corner(field, b, x, y, z));
          float cv[8];
          for (int k = 0; k < 8; ++k)
            cv[k] = corner(field, b, x + (k & 1), y + ((k >> 1) & 1),
                           z + (k >> 2));
          const unsigned code = march_code(cv);
          if (!march_occupied(cv, code, x < rx && y < ry && z < rz)) continue;
          ++c;
          v += march_vertex_count(code);
          i += march_index_count(code);
        }
    cand += finite;
    if (c == 0) continue;
    int* row = list + MARCH_LIST_WIDTH * rows++;
    row[0] = t;
    row[1] = (int)cells;
    row[2] = (int)vertices;
    row[3] = (int)indices;
    cells += c;
    vertices += v;
    indices += i;
  }
  totals[0] = cells;
  totals[1] = vertices;
  totals[2] = indices;
  totals[3] = count_candidates ? cand : 0;
  totals[4] = rows;
}

// march_emit_mesh_kernel, a listed tile (a CTA) at a time, its threads in
// loops: the corners staged at MESH_STAGE_PITCH floats a row (NaN past the
// field's end), a thread a corner row's bits, thread t the occupancy
// (mesh_quad_occupied), codes and counts of the cells 4 t .. 4 t + 3, the
// CTA's exclusive prefixes and the occupied cells' list; then batches of
// MESH_EMIT_THREADS occupied cells, their owner maps, the vertices and
// triangles a thread each. The sort keys are 4 bytes each up to 32 key
// bits, else 8. Returns 0, or -1 where a position or index word was not
// written exactly once.
extern "C" int host_emit_mesh(const float* field, int b, int rx, int ry,
                              int rz, long long ox, long long oy,
                              long long oz, int axis_bits, const int* list,
                              int march_tiles, float* vertices,
                              unsigned* key_hi, unsigned* key_lo,
                              void* sort_keys, int* indices,
                              long long num_vertices, long long num_indices) {
  const int g = tiles_an_axis(b), T = MESH_EMIT_THREADS;
  const MeshFrame frame{{2 * rx, 2 * ry, 2 * rz}, {2 * ox, 2 * oy, 2 * oz},
                        axis_bits};
  const bool narrow = mesh_sort_key_bytes(3 * axis_bits + 1) == 4;
  float staged[MESH_STAGE_ROWS * MESH_STAGE_PITCH];
  unsigned bits[MESH_STAGE_ROWS];
  unsigned cells_x[MARCH_TILE_CELLS], cells_y[MARCH_TILE_CELLS];
  unsigned char v_own[T * MARCH_MAX_CELL_VERTICES];
  unsigned char t_own[T * MARCH_MAX_CELL_INDICES / 3];
  std::vector<int> v_written(3 * num_vertices, 0), i_written(num_indices, 0);
  for (int r = 0; r < march_tiles; ++r) {
    const int* row = list + MARCH_LIST_WIDTH * r;
    const int x0 = row[0] % g * MARCH_TILE, y0 = row[0] / g % g * MARCH_TILE,
              z0 = row[0] / (g * g) * MARCH_TILE;
    for (int k = 0; k < MESH_STAGE_ROWS; ++k) {
      const int y = y0 + k % MARCH_SPAN, z = z0 + k / MARCH_SPAN;
      for (int x = 0; x < MARCH_SPAN; ++x)
        staged[k * MESH_STAGE_PITCH + x] =
            y < b && z < b && x0 + x < b
                ? field[((long long)z * b + y) * b + x0 + x]
                : NAN;
    }
    for (int k = 0; k < MESH_STAGE_ROWS; ++k) {
      unsigned v = 0;
      for (int x = 0; x < MARCH_SPAN; ++x) {
        const float c = staged[k * MESH_STAGE_PITCH + x];
        v |= (march_sign_bit(c) << x) | (march_finite_bit(c) << (16 + x));
      }
      bits[k] = v;
    }
    // the threads' cells and the CTA's exclusive scan, in thread order
    unsigned at = 0, n_cells = 0;
    for (int t = 0; t < T; ++t) {
      const int lz = t / 16, ly = t / 2 % MARCH_TILE,
                lx = MESH_EMIT_CELLS * (t % 2);
      const int ra = lz * MARCH_SPAN + ly, rb = ra + MARCH_SPAN;
      int nx = rx - x0;
      nx = nx < 0 ? 0 : nx > MARCH_TILE ? MARCH_TILE : nx;
      const unsigned occ = mesh_quad_occupied(
          bits[ra], bits[ra + 1], bits[rb], bits[rb + 1], lx,
          y0 + ly < ry && z0 + lz < rz ? (1u << nx) - 1u : 0u);
      for (int j = 0; j < MESH_EMIT_CELLS; ++j) {
        if (!((occ >> j) & 1u)) continue;
        const unsigned code = march_rows_code(bits[ra], bits[ra + 1], bits[rb],
                                              bits[rb + 1], lx + j);
        cells_x[n_cells] = (unsigned)(MESH_EMIT_CELLS * t + j) | (code << 9);
        cells_y[n_cells++] = at;
        at += march_vertex_count(code) | ((march_index_count(code) / 3) << 16);
      }
    }
    const unsigned total = at;
    const long long vertex_at = (unsigned)row[2], index_at = (unsigned)row[3];
    for (unsigned first = 0; first < n_cells; first += T) {
      const unsigned base = cells_y[first];
      const unsigned end = first + T < n_cells ? cells_y[first + T] : total;
      const unsigned bv = base & 0xFFFFu, bt = base >> 16;
      const unsigned nv = (end & 0xFFFFu) - bv, nt = (end >> 16) - bt;
      for (unsigned q = first; q < first + T && q < n_cells; ++q) {
        const unsigned from = cells_y[q];
        const unsigned to = q + 1 < n_cells ? cells_y[q + 1] : total;
        for (unsigned v = (from & 0xFFFFu) - bv; v < (to & 0xFFFFu) - bv; ++v)
          v_own[v] = (unsigned char)(q - first);
        for (unsigned t = (from >> 16) - bt; t < (to >> 16) - bt; ++t)
          t_own[t] = (unsigned char)(q - first);
      }
      for (unsigned v = 0; v < nv; ++v) {
        const unsigned cx_ = cells_x[first + v_own[v]];
        const unsigned cy_ = cells_y[first + v_own[v]];
        const unsigned l = cx_ & 0x1FFu, code = cx_ >> 9;
        const unsigned ends = mesh_vertex_corners(
            &march_vert_corners_h[0][0], code, (int)(bv + v - (cy_ & 0xFFFFu)));
        const unsigned c0 = ends & 0xFu, c1 = ends >> 4;
        const int cx = l % 8, cy = l / 8 % 8, cz = l / 64;
        const int corner = mesh_staged_corner(cx, cy, cz);
        unsigned long long key;
        const long long a = vertex_at + bv + v;
        mesh_vertex(x0 + cx, y0 + cy, z0 + cz, c0, c1,
                    staged[corner + mesh_staged_offset(c0)],
                    staged[corner + mesh_staged_offset(c1)], frame,
                    vertices + 3 * a, key_hi + a, key_lo + a, &key);
        if (narrow)
          static_cast<unsigned*>(sort_keys)[a] = (unsigned)key;
        else
          static_cast<unsigned long long*>(sort_keys)[a] = key;
        for (int k = 0; k < 3; ++k) ++v_written[3 * a + k];
      }
      for (unsigned t = 0; t < nt; ++t) {
        const unsigned cx_ = cells_x[first + t_own[t]];
        const unsigned cy_ = cells_y[first + t_own[t]];
        const int k = 3 * (int)(bt + t - (cy_ >> 16));
        const int first_vertex = (int)(vertex_at + (cy_ & 0xFFFFu));
        const long long at = index_at + 3 * (long long)(bt + t);
        for (int m = 0; m < 3; ++m) {
          indices[at + m] = first_vertex +
                            mesh_index_vertex(&march_index_h[0][0], cx_ >> 9,
                                              k + m);
          ++i_written[at + m];
        }
      }
    }
  }
  for (int w : v_written)
    if (w != 1) return -1;
  for (int w : i_written)
    if (w != 1) return -1;
  return 0;
}

// scan_lookback on the host: `window` words a round (SCAN_WINDOW, or
// scan_lookback_warp's SCAN_WARP_WINDOW), below tile 0 an inclusive 0.
static unsigned long long lookback(const unsigned long long* words,
                                   int stride, long long tile,
                                   int window = SCAN_WINDOW) {
  unsigned long long sum = 0, w[SCAN_WARP_WINDOW];
  long long next = tile - 1;
  while (next >= 0) {
    for (int i = 0; i < window; ++i)
      w[i] = next - i >= 0 ? words[(next - i) * stride]
                           : scan_word(SCAN_INCLUSIVE, 0ULL);
    bool done;
    next -= scan_window_step(w, window, sum, &done);
    if (done) break;
  }
  return sum;
}

// scan_lookback_group on the host, every group sum complete: the groups
// below g nearest first, SCAN_GROUP_WINDOW a round, each its exclusive
// prefix plus its sum where its first tile has published the former, else
// its sum. Counts the rounds in *rounds.
static unsigned long long group_lookback(const unsigned* excl,
                                         const unsigned* sums, int stride,
                                         long long g, int* rounds) {
  unsigned long long sum = 0, w[SCAN_GROUP_WINDOW];
  long long next = g - 1;
  bool done = false;
  *rounds = 0;
  while (!done) {
    for (int i = 0; i < SCAN_GROUP_WINDOW; ++i) {
      const long long q = next - i;
      w[i] = q >= 0 ? scan_group_status(q > 0 ? excl[q * stride] : 0u,
                                        sums[q * stride], q == 0)
                    : scan_word(SCAN_INCLUSIVE, 0ULL);
    }
    next -= scan_window_step(w, SCAN_GROUP_WINDOW, sum, &done);
    ++*rounds;
  }
  return sum;
}

// scan_lookback_in_group on the host: the group's exclusive prefix (0 for
// group 0) plus its lower tiles' counts; -1 where a word it needs is not
// yet published (the card would wait on it).
static long long in_group_lookback(const unsigned* counts,
                                   const unsigned* excl, int stride,
                                   long long tile) {
  const long long g = tile / SCAN_GROUP;
  const int r = (int)(tile - g * SCAN_GROUP);
  const unsigned x = g > 0 ? excl[g * stride] : 1u;
  if (x == 0u) return -1;
  long long sum = x - 1u;
  for (int i = 0; i < r; ++i) {
    const unsigned w = counts[(tile - 1 - i) * stride];
    if (w == 0u) return -1;
    sum += w - 1u;
  }
  return sum;
}

// A tile's exclusive prefix for one count by the two-level look-back
// (sort_pass_body): a group's first tile looks back over the groups below
// and publishes the group's prefix, any other tile adds its group's lower
// tiles' counts to that prefix. -1 as in_group_lookback.
static long long two_level(const unsigned* counts, const unsigned* sums,
                           unsigned* excl, int stride, long long tile,
                           int* rounds) {
  const long long g = tile / SCAN_GROUP;
  *rounds = 0;
  if (tile % SCAN_GROUP != 0) return in_group_lookback(counts, excl, stride,
                                                       tile);
  if (g == 0) return 0;
  const unsigned long long b = group_lookback(excl, sums, stride, g, rounds);
  excl[g * stride] = scan_excl_word((unsigned)b);
  return (long long)b;
}

// The order in which a pass's tiles look back on the host: in ticket order,
// or, `descending`, from the last; for the two-level look-back (`grouped`)
// the groups' first tiles from the last first (each walking every group
// sum below it), then the others.
static std::vector<long long> lookback_order(long long tiles, int descending,
                                             bool grouped) {
  std::vector<long long> order;
  for (int first = 1; first >= 0; --first)
    for (long long k = 0; k < tiles; ++k) {
      const long long t = descending ? tiles - 1 - k : k;
      if (!descending || !grouped ||
          (t % SCAN_GROUP == 0) == (first == 1))
        order.push_back(t);
    }
  order.resize(tiles);
  return order;
}

// sort_pass_body's warp ranking: the lanes whose digit and validity equal
// lane l's.
static unsigned match_digit(const unsigned* d, const bool* valid, int lane) {
  unsigned peers = 0;
  for (int l = 0; l < 32; ++l)
    peers |= (unsigned)(valid[l] == valid[lane] &&
                        (!valid[l] || d[l] == d[lane])) << l;
  return peers;
}

// The weld's sort (weld_sort: the histogram of the top digits, then each
// pass's tiles as its kernel runs them, warps and lanes written out) of K
// keys, K keys between passes: keys in order by their top 8 g bits,
// stably.
// Every tile first publishes its counts (as if all ran at once), then the
// tiles look back in lookback_order, in ticket order or from the last: on
// two levels where `grouped_mode` says so (-1: as the launcher picks,
// sort_grouped), else decoupled. Returns -1 where a tile read an
// unpublished word.
template <typename K>
static int weld_sort(const K* keys, long long n, int bits, int descending,
                     int grouped_mode, long long* sorted, long long* perm) {
  const SortPlan plan = mesh_weld_sort_plan(bits, mesh_sort_passes(bits));
  const int R = SORT_RADIX, W = SORT_THREADS / 32;
  const int I = sort_items(sizeof(K)), T = sort_tile_keys(sizeof(K));
  std::vector<unsigned> hist(plan.passes * R, 0u);
  std::vector<K> kin(n), kout(n);
  std::vector<int> iin(n), iout(n);
  for (long long e = 0; e < n; ++e) {
    kin[e] = keys[e];
    iin[e] = (int)e;
    for (int p = 0; p < plan.passes; ++p)
      ++hist[p * R + sort_digit(kin[e], plan.shift[p], plan.bits[p])];
  }
  const long long tiles = sort_tiles(n, sizeof(K));
  const long long groups = (tiles + SCAN_GROUP - 1) / SCAN_GROUP;
  const bool grouped =
      grouped_mode < 0 ? sort_grouped(tiles) : grouped_mode == 1;
  std::vector<unsigned> words(tiles * R), sums(groups * R), gx(groups * R);
  std::vector<unsigned long long> status(tiles * R);
  std::vector<std::vector<unsigned short>> rank(tiles), warp_count(tiles);
  std::vector<std::vector<unsigned>> count(tiles);
  for (int p = 0; p < plan.passes; ++p) {
    const int shift = plan.shift[p], pbits = plan.bits[p];
    std::fill(words.begin(), words.end(), 0u);
    std::fill(sums.begin(), sums.end(), 0u);
    std::fill(gx.begin(), gx.end(), 0u);
    std::fill(status.begin(), status.end(), 0ULL);
    for (long long tile = 0; tile < tiles; ++tile) {
      const long long first = tile * T;
      const int tile_n = (int)std::min((long long)T, n - first);
      rank[tile].assign(T, 0);
      warp_count[tile].assign(W * R, 0);
      unsigned short* wc = warp_count[tile].data();
      for (int w = 0; w < W; ++w)
        for (int i = 0; i < I; ++i) {
          unsigned d[32], c[32];
          bool valid[32];
          for (int l = 0; l < 32; ++l) {
            const int t = w * 32 * I + 32 * i + l;
            valid[l] = t < tile_n;
            d[l] = sort_digit(valid[l] ? kin[first + t] : (K)0, shift, pbits);
          }
          unsigned peers[32];
          for (int l = 0; l < 32; ++l) {
            peers[l] = match_digit(d, valid, l);
            c[l] = valid[l] ? wc[w * R + d[l]] : 0u;
            const unsigned before =
                __builtin_popcount(peers[l] & ((1u << l) - 1u));
            rank[tile][w * 32 * I + 32 * i + l] =
                (unsigned short)(c[l] + before);
          }
          for (int l = 0; l < 32; ++l)
            if (valid[l] &&
                __builtin_popcount(peers[l] & ((1u << l) - 1u)) == 0)
              wc[w * R + d[l]] =
                  (unsigned short)(c[l] + __builtin_popcount(peers[l]));
        }
      count[tile].assign(R, 0u);
      for (int d = 0; d < R; ++d) {
        unsigned run = 0;
        for (int w = 0; w < W; ++w) {
          const unsigned c = wc[w * R + d];
          wc[w * R + d] = (unsigned short)run;
          run += c;
        }
        count[tile][d] = run;
        words[tile * R + d] = scan_count_word(run);
        sums[tile / SCAN_GROUP * R + d] += scan_group_add(run);
        status[tile * R + d] =
            scan_word(tile == 0 ? SCAN_INCLUSIVE : SCAN_AGGREGATE, run);
      }
    }
    for (long long tile : lookback_order(tiles, descending, grouped)) {
      const long long first = tile * T;
      const int tile_n = (int)std::min((long long)T, n - first);
      std::vector<int> shift_out(R), digit_start(R);
      unsigned excl0 = 0, excl1 = 0;
      for (int d = 0; d < R; ++d) {
        int rounds;
        long long below = 0;
        if (grouped) {
          below = two_level(words.data() + d, sums.data() + d, gx.data() + d,
                            R, tile, &rounds);
          if (below < 0) return -1;
        } else if (tile > 0) {
          below = (long long)lookback(status.data() + d, R, tile);
          status[tile * R + d] =
              scan_word(SCAN_INCLUSIVE, below + count[tile][d]);
        }
        shift_out[d] = (int)(excl1 + below) - (int)excl0;
        digit_start[d] = (int)excl0;
        excl0 += count[tile][d];
        excl1 += hist[p * R + d];
      }
      std::vector<K> staged_keys(T);
      std::vector<int> staged_idx(T);
      for (int t = 0; t < tile_n; ++t) {
        const int w = t / (32 * I);
        const unsigned d = sort_digit(kin[first + t], shift, pbits);
        const int at =
            digit_start[d] + warp_count[tile][w * R + d] + rank[tile][t];
        staged_keys[at] = kin[first + t];
        staged_idx[at] = iin[first + t];
      }
      for (int t = 0; t < tile_n; ++t) {
        const K k2 = staged_keys[t];
        const int at = shift_out[sort_digit(k2, shift, pbits)] + t;
        kout[at] = k2;
        iout[at] = staged_idx[t];
      }
    }
    std::swap(kin, kout);
    std::swap(iin, iout);
  }
  for (long long e = 0; e < n; ++e) {
    sorted[e] = (long long)kin[e];
    perm[e] = iin[e];
  }
  return plan.passes;
}

// The sort as weld_launch picks it: 32-bit keys in and between passes up
// to 32 bits, else 64-bit. Returns the passes.
extern "C" int host_weld_sort(const void* keys, long long n, int bits,
                              int descending, int grouped_mode,
                              long long* sorted, long long* perm) {
  return mesh_sort_key_bytes(bits) == 4
             ? weld_sort<unsigned>(static_cast<const unsigned*>(keys), n,
                                   bits, descending, grouped_mode, sorted,
                                   perm)
             : weld_sort<unsigned long long>(
                   static_cast<const unsigned long long*>(keys), n, bits,
                   descending, grouped_mode, sorted, perm);
}

// The weld's plan of `bits`-bit keys: passes, free bits, the group bound,
// local digits and their width.
extern "C" void host_weld_plan(int bits, long long* out) {
  const int g = mesh_sort_passes(bits);
  const int f = mesh_weld_free_bits(bits, g);
  const SortPlan plan = mesh_weld_sort_plan(bits, g);
  out[0] = g;
  out[1] = f;
  out[2] = mesh_weld_group_bound(bits, f);
  out[3] = mesh_weld_local_digits(f);
  out[4] = mesh_weld_local_width(f);
  out[5] = plan.shift[0];
  out[6] = plan.shift[g - 1] + plan.bits[g - 1];
  out[7] = mesh_weld_shared_bytes((int)out[2]);
}

// weld_local_digit: a warp's stable sort of the slots [s, e) by one local
// digit, 32 slots at a time, its lanes in loops.
static void local_digit(const unsigned* sw, const unsigned* si, unsigned* dw,
                        unsigned* di, int s, int e, int digit, int width,
                        int f) {
  const int left = f - digit * width;
  const int bins = 1 << std::min(left, width);
  std::vector<unsigned> hist(bins, 0u);
  for (int c = s; c < e; c += 32) {
    unsigned d[32];
    bool valid[32];
    for (int l = 0; l < 32; ++l) {
      valid[l] = c + l < e;
      d[l] = valid[l] ? mesh_weld_local_digit(sw[c + l], digit, width, f) : 0u;
    }
    for (int l = 0; l < 32; ++l) {
      const unsigned peers = match_digit(d, valid, l);
      if (valid[l] && (peers & ((1u << l) - 1u)) == 0u)
        hist[d[l]] += __builtin_popcount(peers);
    }
  }
  unsigned run = 0;
  for (int b = 0; b < bins; ++b) {
    const unsigned c = hist[b];
    hist[b] = run;
    run += c;
  }
  for (int c = s; c < e; c += 32) {
    unsigned d[32], at[32], peers[32];
    bool valid[32];
    for (int l = 0; l < 32; ++l) {
      valid[l] = c + l < e;
      d[l] = valid[l] ? mesh_weld_local_digit(sw[c + l], digit, width, f) : 0u;
    }
    for (int l = 0; l < 32; ++l) {
      peers[l] = match_digit(d, valid, l);
      at[l] = valid[l] ? hist[d[l]] : 0u;
    }
    for (int l = 0; l < 32; ++l) {
      if (!valid[l]) continue;
      const unsigned before = __builtin_popcount(peers[l] & ((1u << l) - 1u));
      if (before == 0u) hist[d[l]] = at[l] + __builtin_popcount(peers[l]);
      dw[s + at[l] + before] = sw[c + l];
      di[s + at[l] + before] = si[c + l];
    }
  }
}

// weld_warp_rank: the slots from `first`, a lane each, ranked within their
// groups (`group[l]`, the lanes of lane l's group) by a ballot a free bit;
// lanes in `mine` write their slot at the group's first plus the rank.
// `written` counts the writes of each slot.
static void warp_rank(const unsigned* sw, const unsigned* si, unsigned* dw,
                      unsigned* di, int first, const unsigned* group,
                      const bool* mine, int f, std::vector<int>& written) {
  unsigned word[32], idx[32], equal[32], less[32];
  for (int l = 0; l < 32; ++l) {
    word[l] = mine[l] ? sw[first + l] : 0u;
    idx[l] = mine[l] ? si[first + l] : 0u;
    equal[l] = group[l];
    less[l] = 0u;
  }
  for (int b = f - 1; b >= 0; --b) {
    unsigned ones = 0u;
    for (int l = 0; l < 32; ++l)
      ones |= (unsigned)(mine[l] && ((word[l] >> b) & 1u)) << l;
    for (int l = 0; l < 32; ++l) {
      if ((word[l] >> b) & 1u) {
        less[l] += __builtin_popcount(equal[l] & ~ones);
        equal[l] &= ones;
      } else {
        equal[l] &= ~ones;
      }
    }
  }
  for (int l = 0; l < 32; ++l) {
    if (!mine[l]) continue;
    const int at = first + __builtin_ctz(group[l]) + (int)less[l] +
                   __builtin_popcount(equal[l] & ((1u << l) - 1u));
    dw[at] = word[l];
    di[at] = idx[l];
    ++written[at];
  }
}

// weld_group_kernel, a tile (a CTA) at a time: its tile's words, indices
// and group starts, the last group's overhang a chunk of
// MESH_WELD_THREADS slots at a time, the capacity check, the sort (each
// window of 32 slots ranking the groups inside it at once, a lane each,
// then each group that crosses a window's edge: ranked at once up to 32
// slots, else a local digit at a time; every slot of the range written
// once, checked), then its range's run starts in slot order (the kernel's
// rounds number them the same); every tile's aggregates first, then the
// warp look-backs in ticket order or from the last tile, then each tile's
// writes, the totals (welded, internal, groups past the capacity) from
// the last. `sorted`, `perm`: the sort's top-sorted keys and indices.
// Returns 0, or -1 where a slot was not written exactly once.
template <typename K>
static int weld_group(const long long* sorted, const long long* perm,
                       long long n, int bits, int capacity, int descending,
                       const float* vertices, const unsigned* key_hi,
                       const unsigned* key_lo, float* out_vertices,
                       unsigned* out_hi, unsigned* out_lo, int* remap,
                       long long* totals) {
  const int g = mesh_sort_passes(bits), f = mesh_weld_free_bits(bits, g);
  const int nd = mesh_weld_local_digits(f), width = mesh_weld_local_width(f);
  const int T = MESH_WELD_TILE, TH = MESH_WELD_THREADS, C = MESH_WELD_COUNTS;
  const long long tiles = (n + T - 1) / T;
  auto top = [&](long long e) { return (K)sorted[e] >> f; };
  auto word = [&](long long e) {
    const K k = (K)sorted[e];
    const unsigned ext = (unsigned)(k >> (bits - 1)) & 1u;
    return (unsigned)(k & (((K)1 << f) - (K)1)) | (ext << 31);
  };
  struct Range {
    int lo = 0, hi = 0;
    bool active = false;
    std::vector<unsigned> words, order;
    std::vector<char> starts;
  };
  std::vector<Range> range(tiles);
  std::vector<unsigned long long> sum(tiles * C, 0ULL), status(tiles * C),
      base(tiles * C);
  for (long long tile = 0; tile < tiles; ++tile) {
    Range& r = range[tile];
    const long long t0 = tile * T;
    const int tile_n = (int)std::min((long long)T, n - t0);
    const int slots = T + capacity;
    std::vector<unsigned> wa(slots), ia(slots), wb(slots), ib(slots);
    std::vector<char> gstart(T, 0);
    std::vector<int> groups;
    for (int q = 0; q < tile_n; ++q) {
      const long long p = t0 + q;
      wa[q] = word(p);
      ia[q] = (unsigned)perm[p];
      gstart[q] = p == 0 || top(p) != top(p - 1);
      if (gstart[q]) groups.push_back(q);
    }
    const int ng = (int)groups.size();
    int overflow = 0;
    if (ng > 0) {
      r.lo = groups[0];
      r.hi = tile_n;
      if (t0 + tile_n < n) {
        const int limit = groups[ng - 1] + capacity + 1;
        const K lt = top(t0 + tile_n - 1);
        for (int c = T;; c += TH) {
          int count = 0;
          for (int j = 0; j < TH; ++j) {
            const int q = c + j;
            const long long p = t0 + q;
            const bool same = p < n && q < limit && top(p) == lt;
            if (same) {
              wa[q] = word(p);
              ia[q] = (unsigned)perm[p];
            }
            count += same;
          }
          if (count < TH) {
            r.hi = c + count;
            break;
          }
        }
      }
    }
    for (int k = 0; k < ng; ++k) {
      const int e = k + 1 < ng ? groups[k + 1] : r.hi;
      if (e - groups[k] > capacity) overflow = 1;
    }
    r.active = ng > 0 && overflow == 0;
    std::vector<unsigned>& fw = nd % 2 ? wb : wa;
    std::vector<unsigned>& fi = nd % 2 ? ib : ia;
    if (r.active && nd > 0) {
      std::vector<int> written(slots, 0);
      const int lo = r.lo, hi = r.hi;
      for (int j = lo >> 5; j <= (hi - 1) >> 5; ++j) {
        unsigned group[32];
        bool inside[32];
        unsigned sw = 0u, next = 0u;
        for (int b = 0; b < 32; ++b) {
          if (j < T / 32) sw |= (unsigned)gstart[32 * j + b] << b;
          if (j + 1 < T / 32 && b == 0) next = gstart[32 * (j + 1)];
        }
        for (int l = 0; l < 32; ++l) {
          const int q = 32 * j + l;
          const unsigned below = l == 31 ? 0xFFFFFFFFu : (2u << l) - 1u;
          const unsigned upto = sw & below, above = sw & ~below;
          const int gs = upto ? 31 - __builtin_clz(upto) : -1;
          const int ge = above ? __builtin_ctz(above)
                         : hi <= 32 * j + 32 ? hi - 32 * j
                         : next ? 32 : 33;
          inside[l] = q >= lo && q < hi && gs >= 0 && ge <= 32;
          group[l] = inside[l] ? (ge == 32 ? 0xFFFFFFFFu : (1u << ge) - 1u) &
                                     ~((1u << gs) - 1u)
                               : 0u;
        }
        warp_rank(wa.data(), ia.data(), fw.data(), fi.data(), 32 * j, group,
                  inside, f, written);
      }
      for (int k = 0; k < ng; ++k) {
        const int s = groups[k], e = k + 1 < ng ? groups[k + 1] : r.hi;
        if ((s >> 5) == ((e - 1) >> 5)) continue;   // inside a window
        if (e - s <= 32) {
          unsigned group[32];
          bool mine[32];
          for (int l = 0; l < 32; ++l) {
            mine[l] = l < e - s;
            group[l] = e - s == 32 ? 0xFFFFFFFFu : (1u << (e - s)) - 1u;
          }
          warp_rank(wa.data(), ia.data(), fw.data(), fi.data(), s, group,
                    mine, f, written);
          continue;
        }
        for (int d = 0; d < nd; ++d) {
          if (d % 2 == 0)
            local_digit(wa.data(), ia.data(), wb.data(), ib.data(), s, e, d,
                        width, f);
          else
            local_digit(wb.data(), ib.data(), wa.data(), ia.data(), s, e, d,
                        width, f);
        }
        for (int q = s; q < e; ++q) ++written[q];
      }
      for (int q = lo; q < hi; ++q)
        if (written[q] != 1) return -1;
    }
    r.words = fw;
    r.order = fi;
    r.starts.assign(std::max(r.hi, 1), 0);
    if (r.active)
      for (int q = r.lo; q < r.hi; ++q) {
        const bool start = (q < T && gstart[q]) || r.words[q] != r.words[q - 1];
        r.starts[q] = start;
        sum[tile * C] += start;
        sum[tile * C + 1] += start && (r.words[q] >> 31) == 0u;
      }
    sum[tile * C + 2] = overflow;
  }
  for (long long tile = 0; tile < tiles; ++tile)
    for (int k = 0; k < C; ++k)
      status[tile * C + k] = scan_word(
          tile == 0 ? SCAN_INCLUSIVE : SCAN_AGGREGATE, sum[tile * C + k]);
  for (long long i = 0; i < tiles; ++i) {
    const long long tile = descending ? tiles - 1 - i : i;
    for (int k = 0; k < C; ++k) {
      base[tile * C + k] =
          tile == 0 ? 0
                    : lookback(status.data() + k, C, tile, SCAN_WARP_WINDOW);
      status[tile * C + k] =
          scan_word(SCAN_INCLUSIVE, base[tile * C + k] + sum[tile * C + k]);
    }
  }
  for (long long tile = 0; tile < tiles; ++tile) {
    const Range& r = range[tile];
    if (!r.active) continue;
    long long id = (long long)base[tile * C] - 1;
    for (int q = r.lo; q < r.hi; ++q) {
      const long long v = r.order[q];
      if (r.starts[q]) {
        ++id;
        for (int a = 0; a < 3; ++a) out_vertices[3 * id + a] = vertices[3 * v + a];
        out_hi[id] = key_hi[v];
        out_lo[id] = key_lo[v];
      }
      remap[v] = (int)id;
    }
  }
  for (int k = 0; k < C; ++k)
    totals[k] = (long long)(base[(tiles - 1) * C + k] + sum[(tiles - 1) * C + k]);
  return 0;
}

extern "C" int host_weld_group(const long long* sorted, const long long* perm,
                                long long n, int bits, int capacity,
                                int descending, const float* vertices,
                                const unsigned* key_hi,
                                const unsigned* key_lo, float* out_vertices,
                                unsigned* out_hi, unsigned* out_lo,
                                int* remap, long long* totals) {
  return mesh_sort_key_bytes(bits) == 4
             ? weld_group<unsigned>(sorted, perm, n, bits, capacity,
                                    descending, vertices, key_hi, key_lo,
                                    out_vertices, out_hi, out_lo, remap,
                                    totals)
             : weld_group<unsigned long long>(sorted, perm, n, bits,
                                              capacity, descending, vertices,
                                              key_hi, key_lo, out_vertices,
                                              out_hi, out_lo, remap, totals);
}

// pack_readback_kernel, a thread at a time (nw = 0 for MESH_INDEX_RAW).
extern "C" void host_pack(const float* vertices, const unsigned* key_hi,
                          const unsigned* key_lo, long long nw,
                          const int* triangles, const int* remap,
                          long long nt, long long ox, long long oy,
                          long long oz, int mode, int vertex_words,
                          int* out) {
  const long long org2[3] = {2 * ox, 2 * oy, 2 * oz};
  const long long iw = mode == MESH_INDEX_RAW ? 0 : mesh_index_words(mode, 3 * nt);
  unsigned short* half = (unsigned short*)out;
  unsigned short* vertex_half = half + 2 * iw;
  if (mode == MESH_INDEX_RAW) nw = 0;
  if (nw + nt > 0 && mode != MESH_INDEX_RAW) {
    if (mode == MESH_INDEX_U16 && (3 * nt) % 2 == 1) half[3 * nt] = 0;
    if ((nw * vertex_words) % 2 == 1) vertex_half[nw * vertex_words] = 0;
  }
  for (long long i = 0; i < nw; ++i) {
    unsigned short w[4];
    mesh_vertex_words(vertices + 3 * i, key_hi[i], key_lo[i], org2,
                      vertex_words, w);
    for (int k = 0; k < vertex_words; ++k) vertex_half[i * vertex_words + k] = w[k];
  }
  for (long long t = 0; t < nt; ++t) {
    int idx[3];
    for (int m = 0; m < 3; ++m) idx[m] = remap[triangles[3 * t + m]];
    if (mode == MESH_INDEX_U16) {
      for (int m = 0; m < 3; ++m) half[3 * t + m] = (unsigned short)(idx[m] & 0xFFFF);
    } else if (mode == MESH_INDEX_U21X3) {
      unsigned w0, w1;
      mesh_u21x3(idx[0], idx[1], idx[2], &w0, &w1);
      out[2 * t] = (int)w0;
      out[2 * t + 1] = (int)w1;
    } else {
      for (int m = 0; m < 3; ++m) out[3 * t + m] = idx[m];
    }
  }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """mesh.cuh built for the host (g++ -ffp-contract=off: no FMA, as the
    kernels' _rn intrinsics), loaded with ctypes."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no C++ compiler to build mesh.cuh for the host")
    d = tmp_path_factory.mktemp("mesh_host")
    (d / "harness.cpp").write_text(_HARNESS)
    so = str(d / "libharness.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", CSRC, "-o", so,
                    str(d / "harness.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_max_indices.restype = i32
    lib.host_mesh_tables.argtypes = [p, p]
    for name in ("host_weld_scratch_words", "host_weld_work_words"):
        getattr(lib, name).restype = i64
        getattr(lib, name).argtypes = [i64, i32]
    lib.host_index_words.restype = i64
    lib.host_index_words.argtypes = [i32, i64]
    lib.host_keys.argtypes = [p, i64] + [i32] * 3 + [i64] * 3 + [i32, p, p, p]
    lib.host_list.argtypes = [p] + [i32] * 5 + [p, p]
    lib.host_emit_mesh.restype = i32
    lib.host_emit_mesh.argtypes = ([p] + [i32] * 4 + [i64] * 3
                                   + [i32, p, i32] + [p] * 5 + [i64] * 2)
    lib.host_weld_sort.restype = i32
    lib.host_weld_sort.argtypes = [p, i64, i32, i32, i32, p, p]
    lib.host_weld_plan.argtypes = [i32, p]
    lib.host_weld_group.restype = i32
    lib.host_weld_group.argtypes = [p, p, i64] + [i32] * 3 + [p] * 8
    lib.host_pack.argtypes = ([p] * 3 + [i64] + [p] * 2 + [i64] * 4
                              + [i32] * 2 + [p])
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def key_dtype(bits: int):
    """The compact keys' numpy dtype at `bits` bits: the emission writes
    them, and the weld reads them, 4 bytes each up to 32 bits, else 8."""
    return np.uint32 if mesh_cuda.sort_key_bytes(bits) == 4 else np.int64


def host_chain(lib, field, region, origin, axes=None, descending=False):
    """The kernels run on the host as the wrappers run them on the card:
    the list and totals, the mesh emission, the weld's sort and group
    kernel. Returns a dict of numpy arrays and counts; `axes`: the
    compact key's bits an axis (by default mesh_cuda.axis_bits)."""
    field = np.ascontiguousarray(field, np.float32)
    b = field.shape[0]
    g = -(-(b - 1) // marching.TILE)
    tile_list = np.full((g ** 3, marching_cuda.LIST_WIDTH), -1, np.int32)
    totals = np.empty(len(marching_cuda.TOTALS), np.int64)
    lib.host_list(_ptr(field), b, *region, int(b > marching.TILED_ABOVE),
                  _ptr(tile_list), _ptr(totals))
    t = dict(zip(marching_cuda.TOTALS, totals.tolist()))
    n, ni = t["vertices"], t["indices"]
    axes = mesh_cuda.axis_bits(b) if axes is None else axes
    bits = mesh_cuda.key_bits(axes)
    # poisoned: a slot the emission leaves unwritten shows
    vertices = np.full((n, 3), np.nan, np.float32)
    hi = np.full(n, 0xDEADBEEF, np.uint32)
    lo = np.full(n, 0xDEADBEEF, np.uint32)
    keys = np.full(n, -1, key_dtype(bits))
    tris = np.full((ni // 3, 3), -1, np.int32)
    assert lib.host_emit_mesh(_ptr(field), b, *region, *origin, axes,
                              _ptr(tile_list), t["tiles"], _ptr(vertices),
                              _ptr(hi), _ptr(lo), _ptr(keys), _ptr(tris), n,
                              ni) == 0, \
        "a position or index word not written exactly once"
    assert keys.min(initial=0) >= 0 and (n == 0 or keys.max() < 1 << bits)
    w = host_weld(lib, keys, vertices, hi, lo, bits, descending=descending)
    assert w["past"] == 0
    return dict(totals=t, vertices=vertices, key_hi=hi, key_lo=lo,
                sort_keys=keys, triangles=tris,
                tile_list=tile_list[:t["tiles"]], **w)


def host_weld(lib, keys, vertices, hi, lo, bits, capacity=None,
              descending=False):
    """The weld's kernels on the host as weld_launch runs them: the sort
    over the keys' top digits, then the group kernel (at the plan's
    capacity, or `capacity`). Returns the top-sorted keys and indices, the
    welded arrays, the remap and the totals (`past`: groups past the
    capacity)."""
    n = len(keys)
    keys = np.ascontiguousarray(keys, key_dtype(bits))
    passes, _, bound = mesh_cuda.weld_plan(bits)
    sorted_keys = np.empty(n, np.int64)
    perm = np.empty(n, np.int64)
    assert lib.host_weld_sort(_ptr(keys), n, bits, int(descending), -1,
                              _ptr(sorted_keys), _ptr(perm)) == passes
    out_v = np.full((n, 3), np.nan, np.float32)
    out_hi = np.full(n, 0xDEADBEEF, np.uint32)
    out_lo = np.full(n, 0xDEADBEEF, np.uint32)
    remap = np.full(n, -1, np.int32)
    wt = np.zeros(mesh_cuda.WELD_COUNTS, np.int64)
    if n:
        assert lib.host_weld_group(
            _ptr(sorted_keys), _ptr(perm), n, bits,
            bound if capacity is None else capacity, int(descending),
            _ptr(vertices), _ptr(hi), _ptr(lo), _ptr(out_v), _ptr(out_hi),
            _ptr(out_lo), _ptr(remap), _ptr(wt)) == 0, \
            "a slot of a group kernel's range not sorted exactly once"
    nw, fe, past = (int(v) for v in wt)
    return dict(sorted=sorted_keys, perm=perm, welded_vertices=out_v[:nw],
                welded_hi=out_hi[:nw], welded_lo=out_lo[:nw], remap=remap,
                num_welded=nw, first_external=fe, past=past)


def host_pack(lib, chain, origin, mode, vertex_words):
    """The pack kernel on the host: the image of a PackFormat (mode in
    mesh_cuda.INDEX_MODES), or (mode None) raw's remapped triangles."""
    nw, nt = chain["num_welded"], chain["triangles"].shape[0]
    if mode is None:
        out = np.full((nt, 3), -1, np.int32)
        code = mesh_cuda.INDEX_RAW
    else:
        fmt = block.PackFormat(mode, vertex_words, 13)
        out = np.full(fmt.total_words(3 * nt, nw), -1, np.int32)
        code = mesh_cuda.INDEX_MODES.index(mode)
    lib.host_pack(_ptr(chain["welded_vertices"]), _ptr(chain["welded_hi"]),
                  _ptr(chain["welded_lo"]), nw, _ptr(chain["triangles"]),
                  _ptr(chain["remap"]), nt, *origin, code, vertex_words,
                  _ptr(out))
    return out


def plain_chain(field, region, origin):
    mesh = marching.generate_mesh(torch.as_tensor(field), region, origin)
    welded = weld.weld(mesh.vertices, mesh.key_hi, mesh.key_lo,
                       mesh.triangles)
    return mesh, welded


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_chain_is_plain(lib, chain, mesh, welded, origin):
    """Every array and count of the host chain bit for bit the plain
    chain's, and the pack kernel's image the plain one in every layout."""
    t = chain["totals"]
    assert (t["cells"], t["vertices"], t["indices"], t["candidates"]) == (
        mesh.num_cells, mesh.num_vertices, mesh.num_indices, mesh.num_tiles)
    np.testing.assert_array_equal(_bits(chain["vertices"]),
                                  _bits(mesh.vertices))
    np.testing.assert_array_equal(chain["key_hi"].astype(np.int64),
                                  mesh.key_hi.numpy())
    np.testing.assert_array_equal(chain["key_lo"].astype(np.int64),
                                  mesh.key_lo.numpy())
    np.testing.assert_array_equal(chain["triangles"], mesh.triangles.numpy())
    assert (chain["num_welded"], chain["first_external"]) == (
        welded.num_vertices, welded.first_external)
    np.testing.assert_array_equal(_bits(chain["welded_vertices"]),
                                  _bits(welded.vertices))
    np.testing.assert_array_equal(chain["welded_hi"].astype(np.int64),
                                  welded.key_hi.numpy())
    np.testing.assert_array_equal(chain["welded_lo"].astype(np.int64),
                                  welded.key_lo.numpy())
    np.testing.assert_array_equal(host_pack(lib, chain, origin, None, 0),
                                  welded.triangles.numpy())
    for mode, vw in FORMATS:
        fmt = block.PackFormat(mode, vw, 13)
        np.testing.assert_array_equal(
            host_pack(lib, chain, origin, mode, vw),
            block.pack_readback(welded, origin, fmt).numpy())


def test_header_mesh_tables_are_tables_py(host):
    """marching_tables.h's INDEX_TABLE and VERT_CORNERS (the corner ids at
    the ends of each local vertex's edge, c0 | c1 << 4) as the host build
    reads them are ops/tables.py's."""
    assert host.host_max_indices() == tables.MAX_CELL_INDICES
    index = np.empty((256, tables.MAX_CELL_INDICES), np.int32)
    corners = np.empty((256, tables.MAX_CELL_VERTICES), np.int32)
    host.host_mesh_tables(_ptr(index), _ptr(corners))
    np.testing.assert_array_equal(index, tables.INDEX_TABLE)
    e = tables.EDGES[np.maximum(tables.VERT_TABLE, 0)]
    want = np.where(tables.VERT_TABLE >= 0, e[..., 0] | e[..., 1] << 4, 0)
    np.testing.assert_array_equal(corners, want)
    np.testing.assert_array_equal(corners, marching_cuda.vertex_corners())


@pytest.mark.parametrize("case", CASES)
def test_host_build_equals_the_plain_chain(host, case):
    """The emission, weld and pack kernels on the host against the plain
    generate_mesh -> weld -> pack_readback, bit for bit: unwelded
    vertices, keys and triangles, welded arrays and counts, raw's
    triangles and the image in every index mode and vertex width."""
    field, region, origin = field_case(case)
    chain = host_chain(host, field, region, origin)
    mesh, welded = plain_chain(field, region, origin)
    assert_chain_is_plain(host, chain, mesh, welded, origin)
    if case == "no_surface":
        assert mesh.num_vertices == 0 and chain["num_welded"] == 0
    else:
        assert chain["num_welded"] > 50
    if case == "open":
        assert 0 < chain["first_external"] < chain["num_welded"]
    if case == "wall":
        # every vertex on one kz; the groups of even interior rows at the
        # capacity less the z edge on the region's face kx = 0 (external,
        # so in another group): 188 of 192
        _, f, cap = mesh_cuda.weld_plan(mesh_cuda.key_bits(
            mesh_cuda.axis_bits(field.shape[0])))
        kz = chain["sort_keys"] >> (2 * mesh_cuda.axis_bits(field.shape[0]))
        assert len(np.unique(kz & 0x7F)) == 1
        sizes = np.unique(chain["sorted"] >> f, return_counts=True)[1]
        assert sizes.max() == cap - 4


@pytest.mark.parametrize("axes", [12, 14])
@pytest.mark.parametrize("case", ["noise", "wide"])
def test_host_build_with_wide_keys_and_reversed_lookbacks(host, case, axes):
    """The same with compact keys of 37 and 43 bits (64-bit keys between
    the sort's 4 and 5 passes over the top digits, 5 and 3 free bits for
    the group kernel, a block of 2048^3 and 8192^3 corners) and every
    look-back walked from the last tile."""
    field, region, origin = field_case(case)
    chain = host_chain(host, field, region, origin, axes=axes,
                       descending=True)
    assert mesh_cuda.weld_plan(mesh_cuda.key_bits(axes)) == (
        (4, 5, 96) if axes == 12 else (5, 3, 24))
    mesh, welded = plain_chain(field, region, origin)
    assert_chain_is_plain(host, chain, mesh, welded, origin)


@pytest.mark.parametrize("case", ["dense", "dense_odd"])
def test_host_build_on_dense_tiles(host, case):
    """Tiles whose 512 cells are all occupied with 13 vertices and 12
    triangles each (a batch's owner maps at their worst: 128 cells, 1,664
    vertices, 1,536 triangles), at 256^3 and at 77^3 (corner rows not
    16-byte aligned, tiles cut by the field's end): the host build bit for
    bit the plain chain, every position and index word written once."""
    field, region, origin = field_case(case)
    chain = host_chain(host, field, region, origin)
    mesh, welded = plain_chain(field, region, origin)
    assert_chain_is_plain(host, chain, mesh, welded, origin)
    cells, verts, indices = tile_sizes(chain)
    full = cells == marching.TILE ** 3
    assert full.sum() >= 8
    assert (verts[full] == 512 * tables.MAX_CELL_VERTICES).all()
    assert (indices[full] == 512 * tables.MAX_CELL_INDICES).all()


@pytest.mark.parametrize("axes", [10, 11])
@pytest.mark.parametrize("case", ["noise", "dense_odd"])
def test_host_build_either_side_of_the_key_width_switch(host, case, axes):
    """Compact keys of 31 bits (as at 512^3: 4 bytes each from the
    emission to the weld's passes) and 34 bits (as at 1024^3: 8 bytes).
    3 axes + 1 bits are never 32 or 33, so these are the widths on either
    side of the switch: the same welded mesh on both sides, bit for bit the
    plain chain's."""
    field, region, origin = field_case(case)
    chain = host_chain(host, field, region, origin, axes=axes)
    bits = mesh_cuda.key_bits(axes)
    assert (bits, chain["sort_keys"].itemsize) == (
        (31, 4) if axes == 10 else (34, 8))
    mesh, welded = plain_chain(field, region, origin)
    assert_chain_is_plain(host, chain, mesh, welded, origin)


def test_host_build_with_tiled_candidates(host, monkeypatch):
    """Above marching.TILED_ABOVE corners an axis the counts carry the
    candidate tiles (lowered here, rather than a > 256^3 field built)."""
    monkeypatch.setattr(marching, "TILED_ABOVE", 32)
    field, region, origin = field_case("wide")
    chain = host_chain(host, field, region, origin)
    mesh, welded = plain_chain(field, region, origin)
    assert mesh.num_tiles > 0
    assert_chain_is_plain(host, chain, mesh, welded, origin)


def test_one_cell_blocks_with_every_vertex_on_the_faces(host):
    """One-cell blocks (2 corners an axis, a region of one cell) whose body
    diagonal is not cut: every vertex lies on the region's faces, so the
    weld's internal vertices are none (first_external 0), over every sign
    pattern with corners 0 and 7 alike."""
    rng = np.random.default_rng(5)
    seen = 0
    for code in range(256):
        if ((code >> 0) & 1) != ((code >> 7) & 1) or code in (0, 255):
            continue
        f = np.array([(1.0 if (code >> v) & 1 else -1.0)
                      * (0.25 + rng.random()) for v in range(8)], np.float32)
        field = f.reshape(2, 2, 2)   # [z, y, x]: corner v = x + 2y + 4z
        origin = (7, 100, 3)
        chain = host_chain(host, field, (1, 1, 1), origin)
        mesh, welded = plain_chain(field, (1, 1, 1), origin)
        assert_chain_is_plain(host, chain, mesh, welded, origin)
        assert chain["num_welded"] > 0 and chain["first_external"] == 0
        assert (chain["welded_hi"] >> 31 == 1).all()
        seen += 1
    assert seen == 126


def test_compact_key_order_is_the_global_keys(host):
    """The compact keys (ext, kz, ky, kx) of block-local doubled
    coordinates sort and tie as the global (hi, lo) keys that weld.weld
    sorts (its sign-flipped int64), at origins up to the 21-bit limit
    (2^20 - b cells, doubled 2^21 - 2b) and small ones, with external
    vertices on every face."""
    rng = np.random.default_rng(12)
    for b, origin in ((256, ((1 << 20) - 256,) * 3),
                      (512, ((1 << 20) - 512, 3, (1 << 20) - 700)),
                      (8192, ((1 << 20) - 8192, 0, 12345)),
                      (37, (0, 0, 0))):
        axes = mesh_cuda.axis_bits(b)
        region = tuple(int(v) for v in rng.integers(1, b, 3))
        n = 20000
        k = rng.integers(0, 2 * (b - 1) + 1, size=(n, 3)).astype(np.int32)
        k[: n // 4] = k[rng.integers(0, n, n // 4)]   # many equal keys
        for a in range(3):                            # on each face
            k[n // 4 + a * 100: n // 4 + a * 100 + 50, a] = 0
            k[n // 4 + a * 100 + 50: n // 4 + a * 100 + 100, a] = \
                2 * region[a]
        hi, lo = np.empty(n, np.uint32), np.empty(n, np.uint32)
        sort = np.empty(n, np.uint64)
        host.host_keys(_ptr(k), n, *region, *origin, axes, _ptr(hi),
                       _ptr(lo), _ptr(sort))
        assert int(sort.max()) < 1 << mesh_cuda.key_bits(axes)
        g = k.astype(np.int64) + 2 * np.asarray(origin, np.int64)
        assert g.max() < 1 << mesh_cuda.KEY_AXIS_BITS
        ext = ((k == 0) | (k == 2 * np.asarray(region))).any(axis=1)
        assert ((hi >> 31) == ext).all() and ext.sum() > 300
        glob = (hi.astype(np.uint64) << np.uint64(32)) | lo
        np.testing.assert_array_equal(
            glob, (ext.astype(np.uint64) << np.uint64(63))
            | (g[:, 2].astype(np.uint64) << np.uint64(42))
            | (g[:, 1].astype(np.uint64) << np.uint64(21))
            | g[:, 0].astype(np.uint64))
        skey = torch.as_tensor(glob.view(np.int64)) ^ torch.iinfo(
            torch.int64).min
        want = torch.sort(skey, stable=True).indices.numpy()
        got = np.argsort(sort, kind="stable")
        np.testing.assert_array_equal(got, want)
        same_g = glob[want][1:] == glob[want][:-1]
        same_c = sort[got][1:] == sort[got][:-1]
        np.testing.assert_array_equal(same_c, same_g)


@pytest.mark.parametrize("lookback", ["decoupled", "two_level"])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("bits,n", [(28, 16 * 4096 + 1), (31, 33 * 4096 + 5),
                                    (34, 16 * 2048 - 1),
                                    (43, 33 * 2048 + 1)])
def test_host_weld_sort_across_groups(host, bits, n, descending, lookback):
    """The weld's sort on the host (its passes as their kernels run them,
    each look-back forced, in ticket order and from the last tile) over
    random keys of `bits` bits, 4-byte keys up to 32 bits and 8-byte
    above, at sizes a group of 16 tiles (4,096 keys a tile, 2,048 with
    8-byte keys) and a tile either side of it, and two groups and a tile:
    the keys in order by their top 8 g bits, equal top bits in their
    input order (numpy's stable sort)."""
    rng = np.random.default_rng(bits)
    keys = rng.integers(0, 1 << bits, size=n, dtype=np.uint64)
    keys[rng.random(n) < 0.3] = keys[0]          # a large run of ties
    keys = keys.astype(key_dtype(bits))
    passes, f, _ = mesh_cuda.weld_plan(bits)
    got_k = np.empty(n, np.int64)
    got_p = np.empty(n, np.int64)
    assert host.host_weld_sort(_ptr(keys), n, bits, int(descending),
                               int(lookback == "two_level"), _ptr(got_k),
                               _ptr(got_p)) == passes
    want = np.argsort(keys.astype(np.uint64) >> np.uint64(f), kind="stable")
    np.testing.assert_array_equal(got_p, want)
    np.testing.assert_array_equal(got_k, keys[want].astype(np.int64))


@pytest.mark.parametrize("bits", [7, 28, 31, 34, 43])
def test_weld_scratch_is_the_headers(host, bits):
    """mesh_cuda's scratch and work sizes (the card's allocations, and
    the memory estimate's) are mesh.cuh's."""
    for n in (1, 2047, 2048, 2049, 100_000, 4_000_001):
        assert mesh_cuda.weld_scratch_words(n, bits) == \
            host.host_weld_scratch_words(n, bits)
        assert mesh_cuda.weld_work_words(n, bits) == \
            host.host_weld_work_words(n, bits)
    for mode in range(3):
        fmt = block.PackFormat(mesh_cuda.INDEX_MODES[mode], 3, 8)
        assert host.host_index_words(mode, 3 * 777) == fmt.index_words(3 * 777)


def largest_group(bits: int) -> int:
    """The most keys of one group that a block of the largest size with
    `bits`-bit keys can hold, counted position by position on the plane
    kz = 0 and kz = 1 (the groups never span two kz at these widths): the
    copies of each edge midpoint by its odd coordinates."""
    a = (bits - 1) // 3
    _, f, _ = mesh_cuda.weld_plan(bits)
    assert f <= 2 * a
    kx = np.arange(2 ** a - 1)                  # doubled, 2 (b - 1) at most
    ky = np.arange(2 ** (f - a) if f > a else 2)
    best = 0
    for kz in (0, 1):
        odd = (kx[None, :] & 1) + (ky[:, None] & 1) + kz
        copies = np.asarray(mesh_cuda.WELD_COPIES)[odd]
        group = ((ky[:, None] << a) | kx[None, :]) >> f
        best = max(best, int(np.bincount(group.ravel(),
                                         copies.ravel()).max()))
    return best


@pytest.mark.parametrize("bits,passes", [(28, 3), (31, 3), (34, 4), (37, 4),
                                         (43, 5)])
def test_weld_plan_at_every_key_width(host, bits, passes):
    """The weld's plan (mesh.cuh, mirrored by mesh_cuda): g global passes
    over the top 8 g bits, the free bits below them, and the group
    kernel's capacity C, the largest group those free bits allow. g is the
    least that fits the kernel's largest capacity, C holds the largest
    group a block's edge midpoints form (within the ranges' 1%), and the
    kernel's shared memory at C lets three CTAs share an H100 SM."""
    out = np.zeros(8, np.int64)
    host.host_weld_plan(bits, _ptr(out))
    g, f, cap = mesh_cuda.weld_plan(bits)
    assert (g, f, cap) == tuple(out[:3]) and g == passes
    assert f == bits - 8 * g and (out[5], out[6]) == (f, bits)
    assert cap <= mesh_cuda.WELD_MAX_CAPACITY < mesh_cuda.group_bound(
        bits, f + 8)
    digits, width = out[3], out[4]
    assert digits == -(-f // 8) and digits * width >= f and width <= 8
    worst = largest_group(bits)
    assert 0.99 * cap <= worst <= cap
    assert 3 * (out[7] + 16 * 1024) <= 232_448


@pytest.mark.parametrize("case", ["sphere", "noise", "open", "wall"])
def test_emission_copies_follow_the_odd_coordinates(host, case):
    """The group bound's premise on emitted meshes: a key's copies are at
    most 4 with one odd doubled coordinate (a cube edge), 2 with two (a
    face diagonal), 1 with three (the body diagonal), never all even."""
    field, region, origin = field_case(case)
    chain = host_chain(host, field, region, origin)
    keys, counts = np.unique(chain["sort_keys"], return_counts=True)
    a = mesh_cuda.axis_bits(field.shape[0])
    odd = sum((keys >> (i * a)) & 1 for i in range(3))
    assert (odd > 0).all()
    assert (counts <= np.asarray(mesh_cuda.WELD_COPIES)[odd]).all()
    assert counts.max() == 4


def made_keys(k, region, origin, axes):
    """mesh.cuh's mesh_keys in numpy: the key halves (u32 in int64) and
    the compact sort keys of doubled block-local coordinates k (n, 3)."""
    k = np.asarray(k, np.int64)
    ext = ((k == 0) | (k == 2 * np.asarray(region))).any(axis=1)
    g = k + 2 * np.asarray(origin, np.int64)
    lo = (g[:, 0] | ((g[:, 1] & 0x7FF) << 21)) & 0xFFFFFFFF
    hi = ((g[:, 1] >> 11) | (g[:, 2] << 10) | (ext.astype(np.int64) << 31)) \
        & 0xFFFFFFFF
    sort = ((ext.astype(np.int64) << (3 * axes)) | (k[:, 2] << (2 * axes))
            | (k[:, 1] << axes) | k[:, 0])
    return hi, lo, sort


def made_case(name):
    """(doubled coordinates (n, 3), region, origin, axes) of made keys at
    31 bits (a 512^3 block's: groups (ext, kz, ky, kx >> 7), at most 384
    keys), in a shuffled emission order: every key a 4-fold duplicate;
    groups of 200-384 keys one after another, that straddle the group
    kernel's tiles and carry a range past a round; a group of exactly
    its capacity (a window of 128 kx on an odd ky and an even kz, each
    position's copies by its odd coordinates) among small ones; and that
    with one key more."""
    rng = np.random.default_rng({"fourfold": 1, "straddle": 2,
                                 "at_capacity": 3, "past_capacity": 3}[name])
    region, origin, axes = (400, 410, 420), (40, 3000, 7), 10

    def positions(n):
        p = rng.integers(0, 1023, size=(n, 3))
        return np.unique(p[(p & 1).any(axis=1)], axis=0)

    def full_group(kz, ky):
        kx = np.arange(128, 256)
        copies = np.asarray(mesh_cuda.WELD_COPIES)[(kx & 1) + (ky & 1)
                                                   + (kz & 1)]
        g = np.stack([kx, np.full(128, ky), np.full(128, kz)], 1)
        return np.repeat(g, copies, axis=0)

    if name == "fourfold":
        k = np.repeat(positions(3000), 4, axis=0)
    elif name == "straddle":
        # first six groups of 330 keys, so that the seventh (384) starts
        # at slot 1,980 of the first tile and carries its range to 2,364
        # slots; then groups of 200-384; then small ones (kz > 50)
        parts = []
        for j in range(30):
            g = full_group(40, 2 * j + 1)
            size = 330 if j < 6 else 384 if j == 6 else rng.integers(200, 385)
            parts.append(g[rng.permutation(len(g))[:size]])
        p = positions(1500)
        k = np.concatenate(parts + [p[p[:, 2] > 50]])
    else:
        group = full_group(100, 201)
        assert len(group) == mesh_cuda.weld_plan(31)[2] == 384
        k = np.concatenate([group, np.repeat(positions(3000), 2, axis=0)])
        if name == "past_capacity":
            k = np.concatenate([k, group[:1]])
    return k[rng.permutation(len(k))], region, origin, axes


def made_weld(name):
    """A made case's keys, a random vertex each (so a copy's position
    shows which copy represents its key) and the plain weld of them, with
    triangles (i, i, i) that carry its remap."""
    k, region, origin, axes = made_case(name)
    hi, lo, sort = made_keys(k, region, origin, axes)
    n = len(k)
    vertices = np.random.default_rng(7).random((n, 3)).astype(np.float32)
    tris = torch.arange(n).repeat_interleave(3).reshape(n, 3)
    want = weld.weld(torch.as_tensor(vertices), torch.as_tensor(hi),
                     torch.as_tensor(lo), tris)
    return vertices, hi, lo, sort, want


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ["fourfold", "straddle", "at_capacity",
                                  "past_capacity"])
def test_host_weld_of_made_keys(host, name, descending):
    """The weld's kernels on the host on made 31-bit keys against the plain
    weld, bit for bit (welded vertices, keys, counts and every vertex's
    remap), the group kernel's look-backs in ticket order and from the
    last tile; a group past the capacity counted (the wrapper raises on
    it) and its CTA's range left unwritten."""
    vertices, hi, lo, sort, want = made_weld(name)
    bits = mesh_cuda.key_bits(10)
    w = host_weld(host, sort, vertices, hi.astype(np.uint32),
                  lo.astype(np.uint32), bits, descending=descending)
    top = w["sorted"] >> mesh_cuda.weld_plan(bits)[1]
    sizes = np.unique(top, return_counts=True)[1]
    if name == "past_capacity":
        assert w["past"] == 1 and sizes.max() == 385
        return
    assert w["past"] == 0
    if name == "at_capacity":
        assert sizes.max() == 384
    if name == "straddle":
        starts = np.flatnonzero(np.r_[True, top[1:] != top[:-1]])
        ends = np.r_[starts[1:], len(top)]
        tile = mesh_cuda.WELD_TILE
        assert ((starts // tile) != ((ends - 1) // tile)).sum() >= 3
        # a tile's range (its first group's start to its last group's
        # end) past a round of the group kernel's marks (256 x 9 slots)
        first = np.searchsorted(starts, np.arange(0, len(top), tile))
        last = np.searchsorted(starts, np.arange(tile, len(top) + tile,
                                                 tile)) - 1
        ok = first <= last
        assert (ends[last[ok]] - starts[first[ok]]).max() > 256 * 9
    assert (w["num_welded"], w["first_external"]) == (
        want.num_vertices, want.first_external)
    assert 0 < want.first_external < want.num_vertices
    np.testing.assert_array_equal(_bits(w["welded_vertices"]),
                                  _bits(want.vertices))
    np.testing.assert_array_equal(w["welded_hi"].astype(np.int64),
                                  want.key_hi.numpy())
    np.testing.assert_array_equal(w["welded_lo"].astype(np.int64),
                                  want.key_lo.numpy())
    np.testing.assert_array_equal(w["remap"], want.triangles[:, 0].numpy())


def test_host_weld_counts_groups_past_a_smaller_capacity(host):
    """The group kernel at a capacity below the plan's (the sphere's groups
    against 4 keys) counts the groups past it instead of welding them; at
    the plan's capacity it counts none."""
    field, region, origin = field_case("sphere")
    chain = host_chain(host, field, region, origin)
    bits = mesh_cuda.key_bits(mesh_cuda.axis_bits(field.shape[0]))
    args = (chain["sort_keys"], chain["vertices"], chain["key_hi"],
            chain["key_lo"], bits)
    assert host_weld(host, *args)["past"] == 0
    small = host_weld(host, *args, capacity=4)
    assert small["past"] > 0


# --- against the JAX package --------------------------------------------------

CAPS = dict(cell_cap=1 << 14, vertex_cap=1 << 16, index_cap=3 << 16)
VERTEX_CAPS = {"u16": 1 << 16, "u21x3": 1 << 20, "u32": 1 << 22}
_JAX: dict = {}


def _jax_chain(name):
    """The JAX package's generate(emit="mesh") and weld of a field, once a
    module."""
    if name not in _JAX:
        import functools

        import jax
        import jax.numpy as jnp
        from mlsgpu_tpu.ops import marching as jmarch
        from mlsgpu_tpu.ops import weld as jweld
        field, region, origin = field_case(name)
        m = jax.jit(functools.partial(jmarch.generate, **CAPS))(
            jnp.asarray(field), jnp.asarray(region, jnp.int32),
            jnp.asarray(origin, jnp.int32))
        assert int(m.num_vertices) <= CAPS["vertex_cap"]
        w = jweld.weld(m.vertices, m.key_hi, m.key_lo, m.triangles,
                       m.num_vertices, m.num_indices)
        _JAX[name] = (m, w)
    return _JAX[name]


@pytest.mark.parametrize("name", ["sphere", "open"])
def test_host_build_equals_the_jax_mesh_and_weld(host, name):
    """The host chain's unwelded and welded arrays and counts are the JAX
    package's generate(emit="mesh") and weld live prefixes, bit for bit."""
    field, region, origin = field_case(name)
    m, w = _jax_chain(name)
    chain = host_chain(host, field, region, origin)
    nv, ni, nw = int(m.num_vertices), int(m.num_indices), int(w.num_vertices)
    assert (chain["totals"]["vertices"], chain["totals"]["indices"],
            chain["totals"]["cells"]) == (nv, ni, int(m.num_cells))
    np.testing.assert_array_equal(_bits(chain["vertices"]),
                                  np.asarray(m.vertices)[:nv].view(np.uint32))
    np.testing.assert_array_equal(chain["key_hi"], np.asarray(m.key_hi)[:nv])
    np.testing.assert_array_equal(chain["key_lo"], np.asarray(m.key_lo)[:nv])
    np.testing.assert_array_equal(chain["triangles"],
                                  np.asarray(m.triangles)[:ni // 3])
    assert (chain["num_welded"], chain["first_external"]) == (
        nw, int(w.first_external))
    np.testing.assert_array_equal(_bits(chain["welded_vertices"]),
                                  np.asarray(w.vertices)[:nw].view(np.uint32))
    np.testing.assert_array_equal(chain["welded_hi"], np.asarray(w.key_hi)[:nw])
    np.testing.assert_array_equal(chain["welded_lo"], np.asarray(w.key_lo)[:nw])
    np.testing.assert_array_equal(host_pack(host, chain, origin, None, 0),
                                  np.asarray(w.triangles)[:ni // 3])


@pytest.mark.parametrize("mode,levels", [(mode, levels)
                                         for mode in mesh_cuda.INDEX_MODES
                                         for levels in (3, 7)])
def test_host_pack_equals_the_jax_image(host, mode, levels):
    """The pack kernel's image on the host is the JAX package's
    _pack_readback live prefix, halfword for halfword (its pad halfwords
    hold the JAX image's padding rows, which nothing reads)."""
    import jax
    import jax.numpy as jnp
    from mlsgpu_tpu.ops import block as jblock
    field, region, origin = field_case("open")
    _, w = _jax_chain("open")
    jfmt = jblock.pack_format(levels, 3, VERTEX_CAPS[mode])
    assert jfmt.index_mode == mode
    jimg = np.asarray(jax.jit(jblock._pack_readback,
                              static_argnums=(2, 3, 4))(
        w, jnp.asarray(origin, jnp.int32), jfmt, VERTEX_CAPS[mode],
        CAPS["index_cap"]))
    chain = host_chain(host, field, region, origin)
    img = host_pack(host, chain, origin, mode, jfmt.vertex_words).view(
        np.uint32)
    fmt = block.PackFormat(*jfmt)
    ni, nv = chain["totals"]["indices"], chain["num_welded"]
    iw = fmt.index_words(ni)
    live = np.zeros(2 * len(img), bool)
    live[:2 * iw] = True
    if mode == "u16":
        live[ni:2 * iw] = False
    live[2 * iw:2 * iw + nv * fmt.vertex_words] = True
    np.testing.assert_array_equal(img.view(np.uint16)[live],
                                  jimg[:len(img)].view(np.uint16)[live])


# --- the wrappers on the CPU --------------------------------------------------

def test_wrappers_on_cpu_take_the_plain_chain():
    """On CPU tensors generate_mesh, weld, pack_readback, welded_mesh and
    mesh_image are the plain functions' results, and launch nothing."""
    field, region, origin = field_case("open")
    before = launches.counts()
    f = torch.as_tensor(field)
    mesh = mesh_cuda.generate_mesh(f, region, origin)
    want_mesh, want_welded = plain_chain(field, region, origin)
    for a, b in zip(mesh[:4], want_mesh[:4]):
        assert torch.equal(a, b)
    welded = mesh_cuda.weld(mesh)
    assert isinstance(welded, weld.WeldedMesh)
    assert mesh_cuda.welded_mesh(welded) is welded
    for a, b in zip(welded, want_welded):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    img = mesh_cuda.mesh_image(f, region, origin, 3, 3)
    assert img.fmt == block.pack_format(3, 3, welded.num_vertices)
    assert torch.equal(img.image, block.pack_readback(want_welded, origin,
                                                      img.fmt))
    assert launches.since(before) == dict.fromkeys(launches.KERNELS, 0)


def test_wrappers_refuse_what_the_kernels_cannot_take():
    """A device other than the CPU and CUDA raises; so do an origin whose
    doubled coordinates pass the keys' 21 bits, a negative one, a plain
    mesh or weld handed to the card's kernels, and compact keys not at
    their sort width (int64 at 28 bits, int32 at 34)."""
    field, region, origin = field_case("sphere")
    with pytest.raises(ValueError, match="meta"):
        mesh_cuda.generate_mesh(torch.empty((4, 4, 4), device="meta"),
                                (3, 3, 3), (0, 0, 0))
    mesh_cuda._check_origin(((1 << 20) - 32,) * 3, 32)
    for bad in (((1 << 20) - 31, 0, 0), (0, -1, 0)):
        with pytest.raises(ValueError, match="21 bits"):
            mesh_cuda._check_origin(bad, 32)
    assert mesh_cuda.axis_bits(256) == 9 and mesh_cuda.axis_bits(512) == 10
    assert mesh_cuda.key_bits(9) == 28 and mesh_cuda.key_bits(14) == 43
    mesh, welded = plain_chain(field, region, origin)
    meta = welded._replace(vertices=torch.empty((1, 3), device="meta"))
    with pytest.raises(ValueError, match="card result"):
        mesh_cuda.pack_readback(meta, origin, block.PackFormat("u16", 3, 8))
    for axes, dtype in ((9, torch.int64), (11, torch.int32)):
        card = mesh_cuda.CardMesh(
            vertices=torch.empty((5, 3), device="meta"),
            key_hi=torch.empty(5, dtype=torch.int32, device="meta"),
            key_lo=torch.empty(5, dtype=torch.int32, device="meta"),
            triangles=torch.empty((0, 3), dtype=torch.int32, device="meta"),
            num_cells=2, num_vertices=5, num_indices=0, num_tiles=1,
            sort_keys=torch.empty(5, dtype=dtype, device="meta"),
            axis_bits=axes)
        with pytest.raises(ValueError, match="the weld takes 5 keys"):
            mesh_cuda.weld(card)
    assert mesh_cuda.key_dtype(31) == torch.int32
    assert mesh_cuda.key_dtype(34) == torch.int64


@pytest.mark.parametrize("readback", ["packed", "raw"])
def test_block_step_mesh_branch_on_cpu(readback):
    """The packed and raw branches of block_step on the CPU: the counts in
    COUNTS_FIELDS order with n_occ from the field, the plain image or the
    plain welded arrays."""
    rng = np.random.default_rng(9)
    v = rng.normal(size=(3000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    s = np.zeros((3000, 8), np.float32)
    s[:, 0:3] = 14.0 + 9.0 * v
    s[:, 3] = 1.5
    s[:, 4:7] = v
    s[:, 7] = 1.0
    sp, va = torch.as_tensor(s), torch.ones(3000, dtype=torch.bool)
    res = block.block_step(sp, va, (31, 31, 31), (0, 0, 0), 0.0, levels=3,
                           subsampling=3, readback=readback)
    field, n_occ = block.block_field(sp, va, (31, 31, 31), (0, 0, 0), 0.0,
                                     levels=3, subsampling=3)
    mesh, welded = plain_chain(field.numpy(), (31, 31, 31), (0, 0, 0))
    assert res.counts.tolist() == [
        welded.num_vertices, welded.first_external, welded.num_indices, 0,
        mesh.num_cells, mesh.num_vertices, int(n_occ), mesh.num_tiles]
    assert welded.num_vertices > 1000
    if readback == "packed":
        fmt = block.pack_format(3, 3, welded.num_vertices)
        assert res.fmt == fmt
        assert torch.equal(res.packed, block.pack_readback(welded, (0, 0, 0),
                                                           fmt))
    else:
        for a, b in zip(res.mesh, welded):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)


def test_card_mesh_estimate_counts_the_kernels_buffers():
    """The card's packed and raw estimates (pipeline/resources.py) count
    the kernels' buffers, each as the caching allocator may count it:
    classify's and the scan's, the emission's arrays (the compact keys at
    their sort width, 4 bytes at 28 and 31 bits), the weld's sort and
    group kernel's buffers (mesh_cuda's work and scratch sizes) and the
    image or raw's triangles."""
    from mlsgpu_tpu_torch.pipeline import resources
    from mlsgpu_tpu_torch.tools import cloud
    blk = resources._block
    for levels in (6, 7):
        cfg = cloud.bench_config(0.03, levels)
        b = 1 << cfg.device_shift
        g = -(-(b - 1) // marching.TILE)
        verts = 4 * int((b - 1) ** 3 * resources.SURFACE_CELL_SHARE)
        bits = mesh_cuda.key_bits(mesh_cuda.axis_bits(b))
        assert mesh_cuda.sort_key_bytes(bits) == 4
        for readback in ("packed", "raw"):
            u = resources.estimate_block_usage(cfg, readback, "cuda")
            assert u["marching_kernels"] == (
                blk(8 * g ** 3) + blk(16 * marching_cuda.segment_rows(g))
                + blk(8 * marching_cuda.scan_state_words(g))
                + blk(16 * g ** 3) + blk(40) + blk(12 * verts)
                + 2 * blk(4 * verts) + blk(4 * verts) + blk(12 * verts))
            assert u["weld_kernels"] == (
                blk(4 * mesh_cuda.weld_work_words(verts, bits))
                + blk(8 * mesh_cuda.weld_scratch_words(verts, bits))
                + blk(12 * verts) + 3 * blk(4 * verts) + blk(24))
            assert u["pack_kernels"] == blk(
                4 * (3 * verts + 2 * verts + 1) if readback == "packed"
                else 12 * verts)


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the mesh kernels have no CPU mode)")
    return torch.device("cuda", 0)


def card_field(b, dev, seed=0):
    """A (b, b, b) field on the card like a block's MLS field: a signed
    distance to a bumpy sphere in a shell of defined corners, NaN outside
    it, with NaN holes."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.arange(b, dtype=torch.float32, device=dev)
    z, y, x = torch.meshgrid(g, g, g, indexing="ij")
    c = b / 2.0
    r = torch.sqrt((x - c) ** 2 + (y - 0.9 * c) ** 2 + (z - 1.1 * c) ** 2)
    d = r - 0.4 * b + 2.0 * torch.sin(x / 5.0) * torch.cos(y / 7.0)
    d = torch.where(d.abs() < 6.0, d, torch.full_like(d, float("nan")))
    holes = torch.rand(d.shape, generator=gen, device=dev) < 0.002
    return torch.where(holes, torch.full_like(d, float("nan")), d)


def _words(t: torch.Tensor) -> torch.Tensor:
    """Key halves as int64 u32 values on the CPU."""
    return t.cpu().to(torch.int64) & 0xFFFFFFFF


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.cpu().view(torch.int32),
                                              b.cpu().view(torch.int32))


def assert_card_is_plain(mesh, welded, raw, images, want_mesh, want_welded,
                         origin):
    assert (mesh.num_cells, mesh.num_vertices, mesh.num_indices,
            mesh.num_tiles) == (want_mesh.num_cells, want_mesh.num_vertices,
                                want_mesh.num_indices, want_mesh.num_tiles)
    assert _same_bits(mesh.vertices, want_mesh.vertices)
    assert torch.equal(_words(mesh.key_hi), want_mesh.key_hi.cpu())
    assert torch.equal(_words(mesh.key_lo), want_mesh.key_lo.cpu())
    assert torch.equal(mesh.triangles.cpu().long(), want_mesh.triangles.cpu())
    assert (welded.num_vertices, welded.first_external,
            welded.num_indices) == (want_welded.num_vertices,
                                    want_welded.first_external,
                                    want_welded.num_indices)
    assert _same_bits(welded.vertices, want_welded.vertices)
    assert torch.equal(_words(welded.key_hi), want_welded.key_hi.cpu())
    assert torch.equal(_words(welded.key_lo), want_welded.key_lo.cpu())
    assert torch.equal(raw.triangles.cpu().long(), want_welded.triangles.cpu())
    for (mode, vw), img in images.items():
        want = block.pack_readback(want_welded, origin,
                                   block.PackFormat(mode, vw, 13))
        assert img.shape == want.shape and torch.equal(img.cpu(), want.cpu())


def card_chain(field, region, origin, n_occ=None, axes=None):
    mesh = mesh_cuda.generate_mesh(field, region, origin, n_occ, axes)
    welded = mesh_cuda.weld(mesh)
    images = {(mode, vw): mesh_cuda.pack_readback(
        welded, origin, block.PackFormat(mode, vw, 13))
        for mode, vw in FORMATS}
    return mesh, welded, mesh_cuda.welded_mesh(welded), images


@pytest.mark.cuda
@pytest.mark.parametrize("b", [256, 512, 77, 300])
def test_kernels_bit_for_bit_on_card(cuda_device, b):
    """At 256^3 and 512^3 (28- and 31-bit keys, 3 sort passes) and at
    sizes that are not multiples of a tile's 8 cells: the unwelded mesh,
    the weld, raw's triangles and the image in every layout bit for bit
    the plain chain's on the card; n_occ back with the totals; a launch of
    each kernel (a pass kernel a digit, the pack kernel an image and raw's
    remap)."""
    field = card_field(b, cuda_device)
    region = (b - 1, b // 2 + 3, b - 3)     # the surface leaves it on y
    origin = (64, 2000, 7)
    n_occ = torch.tensor(11, dtype=torch.int32, device=cuda_device)
    before = launches.counts()
    mesh, welded, raw, images = card_chain(field, region, origin, n_occ)
    got = launches.since(before)
    passes = mesh_cuda.sort_passes(mesh_cuda.key_bits(mesh.axis_bits))
    assert [got[k] for k in MESH] == [1, 1, 1, 1, passes, 1,
                                      len(FORMATS) + 1]
    assert passes == 3
    want_mesh = marching.generate_mesh(field, region, origin)
    want_welded = weld.weld(want_mesh.vertices, want_mesh.key_hi,
                            want_mesh.key_lo, want_mesh.triangles)
    torch.cuda.synchronize()
    assert mesh.n_occ == 11
    assert want_welded.num_vertices > (50_000 if b >= 256 else 1_000)
    assert 0 < want_welded.first_external < want_welded.num_vertices
    assert_card_is_plain(mesh, welded, raw, images, want_mesh, want_welded,
                         origin)


@pytest.mark.cuda
@pytest.mark.parametrize("axes", [12, 14])
def test_wide_keys_on_card(cuda_device, axes):
    """Compact keys of 37 and 43 bits (as at 2048^3 and 8192^3 corners:
    64-bit keys between the sort's 4 passes, 5 and 11 free bits) weld a
    256^3 block bit for bit as the plain weld does."""
    field = card_field(256, cuda_device, seed=3)
    region, origin = (255, 250, 252), (5, 6, 7)
    mesh, welded, raw, images = card_chain(field, region, origin, axes=axes)
    want_mesh = marching.generate_mesh(field, region, origin)
    want_welded = weld.weld(want_mesh.vertices, want_mesh.key_hi,
                            want_mesh.key_lo, want_mesh.triangles)
    assert_card_is_plain(mesh, welded, raw, images, want_mesh, want_welded,
                         origin)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [256, 301])
def test_dense_tiles_on_card(cuda_device, b):
    """Tiles whose 512 cells are all occupied with 13 vertices and 12
    triangles each (the emission's owner maps at their worst), at 256^3
    and at 301^3 (corner rows not 16-byte aligned, tiles cut by the
    field's end): bit for bit the plain chain."""
    field, region, origin = (field_case("dense") if b == 256 else
                             dense_field(b, np.random.default_rng(8)))
    field = torch.as_tensor(field, device=cuda_device)
    mesh, welded, raw, images = card_chain(field, region, origin)
    want_mesh = marching.generate_mesh(field, region, origin)
    want_welded = weld.weld(want_mesh.vertices, want_mesh.key_hi,
                            want_mesh.key_lo, want_mesh.triangles)
    assert want_mesh.num_vertices >= 8 * 512 * tables.MAX_CELL_VERTICES
    assert_card_is_plain(mesh, welded, raw, images, want_mesh, want_welded,
                         origin)


@pytest.mark.cuda
@pytest.mark.parametrize("axes", [10, 11])
def test_key_width_switch_on_card(cuda_device, axes):
    """Compact keys of 31 bits (int32 words from the emission to the
    weld's passes) and 34 bits (int64): a 256^3 block welds bit for bit as
    the plain weld does on either side of the switch."""
    field = card_field(256, cuda_device, seed=5)
    region, origin = (255, 251, 255), (9, 8, 7)
    mesh, welded, raw, images = card_chain(field, region, origin, axes=axes)
    assert mesh.sort_keys.dtype == (torch.int32 if axes == 10
                                    else torch.int64)
    want_mesh = marching.generate_mesh(field, region, origin)
    want_welded = weld.weld(want_mesh.vertices, want_mesh.key_hi,
                            want_mesh.key_lo, want_mesh.triangles)
    assert_card_is_plain(mesh, welded, raw, images, want_mesh, want_welded,
                         origin)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [256, 512])
def test_planar_wall_on_card(cuda_device, b):
    """A planar wall (every vertex on one kz): key groups at exactly the
    group kernel's capacity, 48 keys at 256^3 (28-bit keys, 4 free bits)
    and 384 at 512^3 (31 bits, 7 free bits, groups sorted a local digit
    at a time); bit for bit the plain chain."""
    z = torch.arange(b, dtype=torch.float32, device=cuda_device)
    field = (z - (b / 2 + 0.37))[:, None, None].expand(b, b, b).contiguous()
    region, origin = (b - 1,) * 3, (0, 0, 0)
    mesh, welded, raw, images = card_chain(field, region, origin)
    want_mesh = marching.generate_mesh(field, region, origin)
    want_welded = weld.weld(want_mesh.vertices, want_mesh.key_hi,
                            want_mesh.key_lo, want_mesh.triangles)
    assert_card_is_plain(mesh, welded, raw, images, want_mesh, want_welded,
                         origin)
    _, f, cap = mesh_cuda.weld_plan(mesh_cuda.key_bits(mesh.axis_bits))
    largest = int(torch.unique(mesh.sort_keys >> f,
                               return_counts=True)[1].max())
    assert largest == cap


def made_card_mesh(vertices, hi, lo, sort, dev, axes=10):
    """A card mesh of made keys (made_weld), without triangles: keys of
    `axes` bits an axis (31-bit keys by default), at the width the
    emission writes them."""
    n = len(sort)
    word = lambda a: torch.as_tensor(  # noqa: E731
        a.astype(np.uint32).view(np.int32), device=dev)
    return mesh_cuda.CardMesh(
        vertices=torch.as_tensor(vertices, device=dev), key_hi=word(hi),
        key_lo=word(lo), triangles=torch.empty((0, 3), dtype=torch.int32,
                                               device=dev),
        num_cells=0, num_vertices=n, num_indices=0, num_tiles=0,
        sort_keys=torch.as_tensor(sort, device=dev).to(
            mesh_cuda.key_dtype(mesh_cuda.key_bits(axes))), axis_bits=axes)


@pytest.mark.cuda
@pytest.mark.parametrize("axes", [10, 14])
def test_weld_across_sort_groups_on_card(cuda_device, axes):
    """Made keys of 31 bits (4-byte keys, tiles of 4,096) and 43 bits
    (8-byte keys, tiles of 2,048), ~75,000 of them in a shuffled order
    with 1-4 copies a position: the sort's passes run 19 and 37 tiles,
    past one and two groups of the two-level look-back (16 tiles); the
    weld bit for bit the plain weld's, every vertex's remap too."""
    rng = np.random.default_rng(axes)
    region, origin = (400, 410, 420), (40, 3000, 7)
    p = rng.integers(0, 800, size=(40_000, 3))
    p = np.unique(p[(p & 1).any(axis=1)], axis=0)
    k = np.repeat(p, rng.integers(1, 5, size=len(p)), axis=0)
    k = k[rng.permutation(len(k))]
    hi, lo, sort = made_keys(k, region, origin, axes)
    n = len(k)
    tile = 4096 if mesh_cuda.sort_key_bytes(mesh_cuda.key_bits(axes)) == 4 \
        else 2048
    assert -(-n // tile) > (16 if axes == 10 else 32)
    vertices = rng.random((n, 3)).astype(np.float32)
    want = weld.weld(torch.as_tensor(vertices), torch.as_tensor(hi),
                     torch.as_tensor(lo),
                     torch.arange(n).repeat_interleave(3).reshape(n, 3))
    welded = mesh_cuda.weld(made_card_mesh(vertices, hi, lo, sort,
                                           cuda_device, axes))
    assert (welded.num_vertices, welded.first_external) == (
        want.num_vertices, want.first_external)
    assert _same_bits(welded.vertices, want.vertices)
    assert torch.equal(_words(welded.key_hi), want.key_hi)
    assert torch.equal(_words(welded.key_lo), want.key_lo)
    assert torch.equal(welded.remap.cpu().long(), want.triangles[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["straddle", "at_capacity",
                                  "past_capacity"])
def test_group_limit_on_card(cuda_device, name):
    """The group kernel's limit on the card (made 31-bit keys): a group of
    exactly its capacity (384 keys) welds bit for bit as the plain weld
    does, every vertex's remap too; one key more raises instead of
    returning a wrong weld."""
    vertices, hi, lo, sort, want = made_weld(name)
    mesh = made_card_mesh(vertices, hi, lo, sort, cuda_device)
    if name == "past_capacity":
        with pytest.raises(RuntimeError, match="past the group kernel"):
            mesh_cuda.weld(mesh)
        return
    welded = mesh_cuda.weld(mesh)
    assert (welded.num_vertices, welded.first_external) == (
        want.num_vertices, want.first_external)
    assert _same_bits(welded.vertices, want.vertices)
    assert torch.equal(_words(welded.key_hi), want.key_hi)
    assert torch.equal(_words(welded.key_lo), want.key_lo)
    assert torch.equal(welded.remap.cpu().long(), want.triangles[:, 0])


@pytest.mark.cuda
def test_no_surface_on_card(cuda_device):
    """A field without a cut cell: no vertex, an empty image, and no
    launch past classify and scan."""
    field = torch.full((64, 64, 64), float("nan"), device=cuda_device)
    before = launches.counts()
    mesh, welded, raw, images = card_chain(field, (63, 63, 63), (0, 0, 0))
    assert [launches.since(before)[k] for k in MESH] == [1, 1, 0, 0, 0, 0, 0]
    assert (mesh.num_vertices, welded.num_vertices, raw.triangles.shape) == (
        0, 0, (0, 3))
    assert all(img.numel() == 0 for img in images.values())


@pytest.mark.cuda
def test_two_streams_at_once_on_card(cuda_device):
    """Two packed stages on two streams at once (their scans, sorts and
    group kernels each on its own state), each bit for bit its plain
    chain."""
    fields = [card_field(256, cuda_device, seed=s) for s in (1, 2)]
    region, origin = (255, 255, 255), (0, 0, 0)
    wants = []
    for f in fields:
        m = marching.generate_mesh(f, region, origin)
        wants.append((m, weld.weld(m.vertices, m.key_hi, m.key_lo,
                                   m.triangles)))
    streams = [torch.cuda.Stream(cuda_device) for _ in fields]
    torch.cuda.synchronize()
    outs = [None, None]
    for r in range(3):
        for i, (f, s) in enumerate(zip(fields, streams)):
            with torch.cuda.stream(s):
                outs[i] = card_chain(f, region, origin)
        torch.cuda.synchronize()
        for (mesh, welded, raw, images), (wm, ww) in zip(outs, wants):
            assert_card_is_plain(mesh, welded, raw, images, wm, ww, origin)


@pytest.mark.cuda
def test_launches_and_syncs_a_stage_on_card(cuda_device):
    """A traced packed stage (mesh_image) issues classify, scan, the mesh
    emission, the sort's histogram and three passes (28-bit keys), the
    group kernel and the pack kernel, and at most two syncs (the totals,
    the welded counts)."""
    import json
    import tempfile
    import torch.profiler as tp
    from mlsgpu_tpu_torch.utils import step_profile
    field = card_field(256, cuda_device)
    region, origin = (255, 255, 255), (0, 0, 0)
    mesh_cuda.mesh_image(field, region, origin, 6, 3)
    torch.cuda.synchronize()
    with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                tp.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with tp.record_function(step_profile.STEP):
                mesh_cuda.mesh_image(field, region, origin, 6, 3)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            summary = step_profile.summarize(json.load(f))
    assert summary["launches"] == 9
    assert summary["sync_calls"] <= 2


@pytest.mark.cuda
def test_each_wait_on_the_card_is_inside_the_sync_hook(cuda_device):
    """The `sync` hook (the streamer's `sync` span) is entered once around
    each host wait: classify's totals, generate_mesh's (the same), the
    weld's counts; the stream is idle when each ends."""
    import contextlib
    field = card_field(256, cuda_device)
    region, origin = (255, 255, 255), (0, 0, 0)
    entered = []

    @contextlib.contextmanager
    def sync():
        entered.append(torch.cuda.current_stream(cuda_device).query())
        yield
        assert torch.cuda.current_stream(cuda_device).query()

    marching_cuda.classify(field, region, sync=sync)
    assert len(entered) == 1
    mesh = mesh_cuda.generate_mesh(field, region, origin, sync=sync)
    assert len(entered) == 2
    mesh_cuda.weld(mesh, sync=sync)
    assert len(entered) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [6, 7])
@pytest.mark.parametrize("readback", ["packed", "raw"])
def test_mesh_estimate_holds_the_stage_on_card(cuda_device, levels,
                                               readback):
    """The card's packed and raw estimates (pipeline/resources.py) hold
    what one stage allocates on a block's field at 256^3 and 512^3: the
    peak of torch.cuda.max_memory_allocated above the field."""
    from mlsgpu_tpu_torch.pipeline import resources
    from mlsgpu_tpu_torch.tools import cloud
    cfg = cloud.bench_config(0.03, levels)
    b = 1 << cfg.device_shift
    usage = resources.estimate_block_usage(cfg, readback, "cuda")
    field = card_field(b, cuda_device)
    region, origin = (b - 1,) * 3, (0, 0, 0)
    torch.cuda.synchronize(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    mesh = mesh_cuda.generate_mesh(field, region, origin)
    welded = mesh_cuda.weld(mesh)
    if readback == "packed":
        out = mesh_cuda.pack_readback(
            welded, origin, block.pack_format(levels, 3,
                                              welded.num_vertices)).numel()
    else:
        out = mesh_cuda.welded_mesh(welded).triangles.numel()
    torch.cuda.synchronize(cuda_device)
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert mesh.num_vertices > 10_000 and out > 0
    assert 0 < peak <= (usage["marching_kernels"] + usage["weld_kernels"]
                        + usage["pack_kernels"])
