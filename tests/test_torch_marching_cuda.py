"""The codes path's marching kernels (ops/marching_cuda.py,
csrc/marching.cu).

On the CPU: the kernels' arithmetic (csrc/marching.cuh) built for the host
with g++ -ffp-contract=off, with host loops that run the three kernels
warp by warp (classify a column of 8 by 2 tiles walking a run along z, its
lanes' sign and finite words and occupied words as the kernel makes them;
the scan a range of segments a thread; emit a listed tile a warp, its
occupied cells ranked and its vertices spread a lane each through the
owner map, writing bytes and halfwords into the image), held bit for bit,
image and counts, to the plain `block.pack_codes(
marching.generate_codes(...))` and to the JAX package's
`generate(emit="codes")` + `_pack_codes` live prefix, on fields made from a
numpy seed: a sphere, region edges that are not multiples of 8, a block
of 10 tiles an axis (two row segments), all NaN (an empty image), all
positive, one bipolar cell, exact 0.0 and -0.0 corners, subnormal
differences, +inf and -inf beside NaN, -0.0 and subnormals, sizes that
are not multiples of 4 (37, 21), and the tiled rule's candidate tiles
(marching.TILED_ABOVE lowered rather than a > 256^3 field built); the
z-walk with runs of 2, 4 and 8 tiles (a shorter last run); the word
helpers against march_code and march_occupied on every sign pattern with
each corner made non-finite; t16 against torch's formula on edge values;
the header's tables against ops/tables.py; the wrapper on CPU tensors
(the plain image, no launch) and on a device it cannot take (raises); the
card's memory estimate of the codes stage. On the card (marker `cuda`):
the kernels' image bit for bit the plain one at 256^3, 512^3 and at 77,
300 and 600 corners an axis, an empty field, two images on two streams at
once, one launch of each kernel and at most one sync a call, and the
memory estimate above what a codes stage allocates.

Only the JAX comparison imports jax, inside its test: the card's machine
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
                                  tables)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mlsgpu_tpu_torch", "csrc")

#: The marching kernels' names in ops/launches.py.
MARCHING = ("march_classify", "march_scan", "march_emit")


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
    """(field (B, B, B) f32 [z, y, x], region (x, y, z) cells) of a test
    case, from a numpy seed."""
    rng = np.random.default_rng(31)
    if name == "sphere":
        return sphere_field(32, (15.5, 15.3, 15.8), 9.0), (31, 31, 31)
    if name == "region_edges":
        f = sphere_field(20, (12.0, 6.0, 9.5), 7.0)
        f[rng.random(f.shape) < 0.02] = np.nan
        return f, (13, 19, 7)
    if name == "all_nan":
        return np.full((16, 16, 16), np.nan, np.float32), (15, 15, 15)
    if name == "all_positive":
        return (rng.random((16, 16, 16)) + 0.5).astype(np.float32), \
            (15, 15, 15)
    if name == "one_cell":
        f = np.full((16, 16, 16), np.nan, np.float32)
        f[9:11, 4:6, 7:9] = 1.0
        f[10, 4, 8] = -0.25
        return f, (15, 15, 15)
    if name == "zeros":
        # exact 0.0 and -0.0 beside small values of both signs: -0.0 is
        # outside (>= 0), a cut edge runs from 0.0 to a negative value
        vals = np.float32([0.0, -0.0, 0.5, -0.5, 1e-3, -1e-3, 2.0, -2.0])
        return rng.choice(vals, size=(16, 16, 16)), (15, 14, 13)
    if name == "subnormal":
        # subnormal corners and differences: t from iso0 / (iso0 - iso1)
        # with both tiny, or one tiny and one huge
        tiny = np.float32([1e-45, 3e-45, 1e-42, 7e-41, 1.1754942e-38,
                           1e-38, 0.0])
        big = np.float32([1.0, 3e38, 1e-30])
        mags = np.concatenate([tiny] * 3 + [big])
        f = rng.choice(mags, size=(24, 24, 24)) * rng.choice(
            np.float32([-1.0, 1.0]), size=(24, 24, 24))
        return f.astype(np.float32), (23, 23, 23)
    if name == "wide":
        # 10 tiles an axis: two row segments of the classify pass, the
        # second of two tiles
        f = sphere_field(76, (40.0, 33.0, 37.0), 29.0)
        f[rng.random(f.shape) < 0.01] = np.nan
        return f, (75, 70, 61)
    if name == "infinities":
        # +inf and -inf corners beside NaN, -0.0, 0.0 and subnormals: +inf
        # is >= 0 (its sign bit set) but no cell with it is occupied
        vals = np.float32([np.inf, -np.inf, np.nan, -0.0, 0.0, 1e-45, -1e-45,
                           3e-39, -7e-41, 0.5, -0.5, 2.0, -2.0, 1e-3, -1e-3])
        p = np.array([0.02, 0.02, 0.02, 0.06, 0.06, 0.04, 0.04, 0.04, 0.04,
                      0.14, 0.14, 0.14, 0.14, 0.05, 0.05])
        return rng.choice(vals, size=(24, 24, 24), p=p / p.sum()), \
            (23, 21, 22)
    if name == "odd_37":
        # b = 37 (not a multiple of 4): 5 tiles an axis, one row segment
        # of 5 tiles, three bands of 2, 2 and 1 tiles; forced runs of 2, 4
        # and 8 tiles leave a shorter last run
        f = sphere_field(37, (18.0, 16.5, 19.2), 12.5)
        f[rng.random(f.shape) < 0.02] = np.nan
        return f, (36, 31, 35)
    if name == "odd_21":
        # b = 21: 3 tiles an axis, one band of 2 and one of 1
        f = sphere_field(21, (10.2, 9.6, 11.1), 6.5)
        return f, (20, 20, 17)
    if name == "noise":
        # a dense random field: most cells cut, many tiles full
        f = rng.normal(size=(40, 40, 40)).astype(np.float32)
        f[rng.random(f.shape) < 0.05] = np.nan
        return f, (39, 33, 38)
    raise KeyError(name)


CASES = ("sphere", "region_edges", "all_nan", "all_positive", "one_cell",
         "zeros", "subnormal", "noise", "wide", "infinities", "odd_37",
         "odd_21")


def _plain(field, region, tiled=None):
    """The plain image (int32 numpy) and counts."""
    cm = marching.generate_codes(torch.as_tensor(field), region, tiled=tiled)
    return block.pack_codes(cm).numpy(), cm


# --- the kernels' arithmetic, built for the host ------------------------------

# The kernels' bodies (csrc/marching.cu) as host loops over marching.cuh,
# their warps and lanes written out: classify a column (a row segment of
# MARCH_ROW_TILES tiles along x, MARCH_BAND_TILES along y, a run along z) a
# warp, walked a corner plane at a time: each lane's sign and finite words
# of its row half, its next row from the next lane (the band's last row by
# ballot), the plane below kept, the occupied word of its 32 cells, the
# layer's sums by tile over eight lanes; the scan a segment a thread, a
# tile of MARCH_SCAN_THREADS segments a CTA: every tile's aggregates, then
# each tile's look-back over the status words (scan.cuh), then its
# threads' list rows from the tile's bases and their exclusive sums in
# the CTA, and the totals from the last tile; emit a listed tile a warp: its corner rows' bits, the 16 cell words'
# occupied cells ranked into a list, then 32 of them at a time, their
# vertices spread over the lanes through the owner map.
_HARNESS = """
#include <math.h>
#include <string.h>

#include <vector>

#include "marching.cuh"
#include "scan.cuh"

extern "C" int host_num_edges() { return MARCH_NUM_EDGES; }
extern "C" int host_max_vertices() { return MARCH_MAX_CELL_VERTICES; }

extern "C" void host_tables(int* edges, int* counts, int* verts,
                            int* offsets) {
  for (int e = 0; e < MARCH_NUM_EDGES; ++e)
    for (int k = 0; k < 2; ++k) edges[2 * e + k] = march_edges_h[e][k];
  for (int c = 0; c < 256; ++c) {
    counts[2 * c] = (int)march_vertex_count(c);
    counts[2 * c + 1] = (int)march_index_count(c);
    for (int j = 0; j < MARCH_MAX_CELL_VERTICES; ++j) {
      verts[c * MARCH_MAX_CELL_VERTICES + j] = march_verts_h[c][j];
      offsets[c * MARCH_MAX_CELL_VERTICES + j] =
          (int)march_vertex_end_offsets(&march_end_offsets_h[0][0], c, j);
    }
  }
}

extern "C" void host_t16(const float* iso0, const float* iso1, long long n,
                         unsigned* t16) {
  for (long long i = 0; i < n; ++i) t16[i] = march_t16(iso0[i], iso1[i]);
}

// The word helpers against march_code and march_occupied: every sign
// pattern of a cell's eight corners (>= 0: 0.0, -0.0 or 2.5; below: a
// negative value), as it is and with each corner in turn NaN, +inf or
// -inf, in and out of the region; the cell at bits 0, 13, 30 and 31 of
// classify's row words (its dx = 1 corners by march_next_corners, across
// the word's end at 31) and at four places of emit's row bytes
// (march_row_bytes; the code also by march_rows_code), the other bits
// noise. Returns the mismatches;
// *checks the cases held.
extern "C" int host_check_masks(long long* checks) {
  const float bad[3] = {NAN, INFINITY, -INFINITY};
  const int xs[4] = {0, 13, 30, 31};
  const int bytes[4][2] = {{0, 0}, {1, 7}, {3, 3}, {2, 6}};  // (row, x)
  const unsigned noise = 0xA5C3F00Fu;
  int wrong = 0;
  *checks = 0;
  for (int p = 0; p < 256; ++p)
    for (int which = -1; which < 8; ++which)
      for (int kind = 0; kind < (which < 0 ? 1 : 3); ++kind) {
        float c[8];
        for (int v = 0; v < 8; ++v)
          c[v] = (p >> v) & 1 ? (v % 3 == 0 ? 0.0f : v % 3 == 1 ? -0.0f : 2.5f)
                              : -1.25f - (float)v;
        if (which >= 0) c[which] = bad[kind];
        for (int in = 0; in < 2; ++in) {
          const unsigned code = march_code(c);
          const bool occupied = march_occupied(c, code, in == 1);
          for (int place = 0; place < 8; ++place) {
            unsigned sign[8], fin[8];
            int x;
            if (place < 4) {
              // classify: each corner row (dy, dz) as two words, the cell's
              // corners at bits x and x + 1 of the 64
              x = xs[place];
              for (int row = 0; row < 4; ++row) {
                unsigned long long s = ((unsigned long long)noise << 32) | ~noise;
                unsigned long long f = ~s;
                s &= ~(3ULL << x);
                f &= ~(3ULL << x);
                for (int dx = 0; dx < 2; ++dx) {
                  const float v = c[dx + 2 * row];
                  s |= (unsigned long long)march_sign_bit(v) << (x + dx);
                  f |= (unsigned long long)march_finite_bit(v) << (x + dx);
                }
                sign[2 * row] = (unsigned)s;
                fin[2 * row] = (unsigned)f;
                sign[2 * row + 1] = march_next_corners((unsigned)s,
                                                       (unsigned)(s >> 32));
                fin[2 * row + 1] = march_next_corners((unsigned)f,
                                                      (unsigned)(f >> 32));
              }
            } else {
              // emit: each corner row (dy, dz) as tile rows, sign bits 0-8,
              // finite bits 16-24, the cell in row i at x; its code also
              // from the four rows (march_rows_code)
              const int i = bytes[place - 4][0], lx = bytes[place - 4][1];
              unsigned cell_rows[4];
              x = 8 * i + lx;
              for (int row = 0; row < 4; ++row) {
                unsigned rows4[4];
                for (int k = 0; k < 4; ++k) rows4[k] = noise * (k + 1) + row;
                unsigned w = rows4[i] & ~((3u << lx) | (3u << (16 + lx)));
                for (int dx = 0; dx < 2; ++dx) {
                  const float v = c[dx + 2 * row];
                  w |= (march_sign_bit(v) << (lx + dx)) |
                       (march_finite_bit(v) << (16 + lx + dx));
                }
                rows4[i] = cell_rows[row] = w;
                for (int dx = 0; dx < 2; ++dx) {
                  sign[dx + 2 * row] = march_row_bytes(rows4, dx);
                  fin[dx + 2 * row] = march_row_bytes(rows4, 16 + dx);
                }
              }
              wrong += march_rows_code(cell_rows[0], cell_rows[1],
                                       cell_rows[2], cell_rows[3], lx) != code;
            }
            const unsigned region = in ? noise | (1u << x) : noise & ~(1u << x);
            const unsigned occ = march_word_occupied(sign, fin, region);
            wrong += march_word_code(sign, x) != code ||
                     (((occ >> x) & 1u) != 0) != occupied;
            ++*checks;
          }
        }
      }
  return wrong;
}

static float corner(const float* field, int b, int x, int y, int z) {
  return x < b && y < b && z < b ? field[((long long)z * b + y) * b + x] : NAN;
}

static int tiles_an_axis(int b) { return (b - 1 + MARCH_TILE - 1) / MARCH_TILE; }

static int imin(int a, int b) { return a < b ? a : b; }

extern "C" int host_segment_rows(int b) {
  const int g = tiles_an_axis(b);
  return g * g * march_segments(g);
}

extern "C" int host_run_tiles(int b) { return march_run_tiles(tiles_an_axis(b)); }

// march_classify_kernel with runs of run_tiles, a warp (a column) at a
// time, its lanes in loops. Returns the warps.
extern "C" int host_classify(const float* field, int b, int rx, int ry, int rz,
                             int run_tiles, unsigned* records, unsigned* rows) {
  const int g = tiles_an_axis(b), segments = march_segments(g),
            bands = march_bands(g), runs = (g + run_tiles - 1) / run_tiles;
  const int band_rows = MARCH_BAND_TILES * MARCH_TILE;
  for (int task = 0; task < segments * bands * runs; ++task) {
    const int seg = task % segments, band = task / segments % bands,
              run = task / (segments * bands);
    const int ty0 = band * MARCH_BAND_TILES, tz0 = run * run_tiles;
    const int n = imin(MARCH_ROW_TILES, g - seg * MARCH_ROW_TILES);
    const int layers = imin(run_tiles, g - tz0);
    const int planes = layers * MARCH_TILE + 1;
    const int x0 = seg * MARCH_ROW_TILES * MARCH_TILE, y0 = ty0 * MARCH_TILE,
              z0 = tz0 * MARCH_TILE;
    unsigned below_s[32][4], below_f[32][4], own[32], cells[32], sums[32][4];
    memset(below_s, 0, sizeof below_s);
    memset(below_f, 0, sizeof below_f);
    memset(own, 0, sizeof own);
    memset(cells, 0, sizeof cells);
    memset(sums, 0, sizeof sums);
    for (int q = 0; q < planes; ++q) {
      // each lane's row half (y, h): its word and next corner; the band's
      // last row by ballot
      unsigned s[32], f[32], next[32], last_s[2] = {0, 0}, last_f[2] = {0, 0};
      unsigned last_ts = 0, last_tf = 0;
      for (int lane = 0; lane < 32; ++lane) {
        const int y = lane % band_rows, h = lane / band_rows;
        s[lane] = f[lane] = 0;
        for (int x = 0; x < 32; ++x) {
          const float v = corner(field, b, x0 + 32 * h + x, y0 + y, z0 + q);
          s[lane] |= march_sign_bit(v) << x;
          f[lane] |= march_finite_bit(v) << x;
        }
        const float v = corner(field, b, x0 + 32 * h + 32, y0 + y, z0 + q);
        next[lane] = march_sign_bit(v) | (march_finite_bit(v) << 1);
        for (int hh = 0; hh < 2; ++hh) {
          const float l = corner(field, b, x0 + 32 * hh + lane, y0 + band_rows,
                                 z0 + q);
          last_s[hh] |= march_sign_bit(l) << lane;
          last_f[hh] |= march_finite_bit(l) << lane;
        }
        if (lane < 2) {
          const float l = corner(field, b, x0 + 32 * lane + 32, y0 + band_rows,
                                 z0 + q);
          last_ts |= march_sign_bit(l) << lane;
          last_tf |= march_finite_bit(l) << lane;
        }
      }
      for (int lane = 0; lane < 32; ++lane) {
        const int y = lane % band_rows, h = lane / band_rows;
        // row y + 1: the next lane's (the band's last row for y = 15)
        unsigned s1 = s[(lane + 1) % 32], f1 = f[(lane + 1) % 32],
                 next1 = next[(lane + 1) % 32];
        if (y == band_rows - 1) {
          s1 = last_s[h];
          f1 = last_f[h];
          next1 = ((last_ts >> h) & 1u) | (((last_tf >> h) & 1u) << 1);
        }
        const unsigned now_s[4] = {s[lane], march_next_corners(s[lane], next[lane]),
                                   s1, march_next_corners(s1, next1)};
        const unsigned now_f[4] = {f[lane],
                                   march_next_corners(f[lane], next[lane] >> 1),
                                   f1, march_next_corners(f1, next1 >> 1)};
        if (q > 0) {
          unsigned sign[8], fin[8];
          for (int i = 0; i < 4; ++i) {
            sign[i] = below_s[lane][i];
            sign[4 + i] = now_s[i];
            fin[i] = below_f[lane][i];
            fin[4 + i] = now_f[i];
          }
          const int left = rx - (x0 + 32 * h);
          const unsigned region_x =
              left >= 32 ? 0xFFFFFFFFu : left <= 0 ? 0u : (1u << left) - 1u;
          const bool in = y0 + y < ry && z0 + q - 1 < rz;
          const unsigned occ = march_word_occupied(sign, fin, in ? region_x : 0u);
          for (int j = 0; j < 4; ++j)
            cells[lane] += (unsigned)__builtin_popcount(occ & (0xFFu << (8 * j)))
                           << (8 * j);
          for (int x = 0; x < 32; ++x)
            if ((occ >> x) & 1u)
              sums[lane][x / MARCH_TILE] +=
                  march_cell_counts(march_word_code(sign, x));
        }
        for (int i = 0; i < 4; ++i) {
          below_s[lane][i] = now_s[i];
          below_f[lane][i] = now_f[i];
        }
      }
      if (q > 0 && q % MARCH_TILE == 0) {
        // layer k: each tile's sums over its eight lanes
        const int k = q / MARCH_TILE - 1;
        for (int t = 0; t < MARCH_BAND_TILES; ++t) {
          if (ty0 + t >= g) continue;
          unsigned seg_sum[4] = {0, 0, 0, 0};
          const long long row = (long long)(tz0 + k) * g + ty0 + t;
          for (int tx = 0; tx < n; ++tx) {
            const int h = tx / 4, j = tx % 4;
            unsigned c = 0, anyfin = 0, sum = 0;
            for (int i = 0; i < MARCH_TILE; ++i) {
              const int lane = 16 * h + 8 * t + i;
              c += (cells[lane] >> (8 * j)) & 0xFFu;
              anyfin |= (own[lane] >> (8 * j)) & 0xFFu;
              sum += sums[lane][j];
            }
            records[2 * (row * g + seg * MARCH_ROW_TILES + tx)] =
                c | (anyfin ? 1u << 16 : 0u);
            records[2 * (row * g + seg * MARCH_ROW_TILES + tx) + 1] = sum;
            seg_sum[0] += (c > 0 ? 1u : 0u) | (anyfin ? 1u << 16 : 0u);
            seg_sum[1] += c;
            seg_sum[2] += march_tile_vertices(sum);
            seg_sum[3] += march_tile_indices(sum);
          }
          for (int i = 0; i < 4; ++i)
            rows[4 * (row * segments + seg) + i] = seg_sum[i];
        }
        memset(own, 0, sizeof own);
        memset(cells, 0, sizeof cells);
        memset(sums, 0, sizeof sums);
      }
      if (q < planes - 1)
        for (int lane = 0; lane < 32; ++lane) own[lane] |= f[lane];
    }
  }
  return segments * bands * runs;
}

extern "C" int host_scan_state_words(int b) {
  const int g = tiles_an_axis(b);
  return (int)march_scan_state_words(g * g * march_segments(g));
}

// scan_lookback on the host: SCAN_WINDOW words a round, below tile 0 an
// inclusive 0.
static unsigned long long lookback(const unsigned long long* words,
                                   int stride, int tile) {
  unsigned long long sum = 0, w[SCAN_WINDOW];
  int next = tile - 1;
  while (next >= 0) {
    for (int i = 0; i < SCAN_WINDOW; ++i)
      w[i] = next - i >= 0 ? words[(long long)(next - i) * stride]
                           : scan_word(SCAN_INCLUSIVE, 0ULL);
    bool done;
    next -= scan_window_step(w, SCAN_WINDOW, sum, &done);
    if (done) break;
  }
  return sum;
}

// A segment's counts in the totals' order (cells, vertices, indices,
// candidate tiles, occupied tiles); zero past the last segment.
static void segment_counts(const unsigned* rows, int nrows, int r,
                           unsigned v[MARCH_TOTALS]) {
  const unsigned* seg = rows + 4 * (long long)r;
  const bool in = r < nrows;
  v[MARCH_TOTAL_CELLS] = in ? seg[1] : 0u;
  v[MARCH_TOTAL_VERTICES] = in ? seg[2] : 0u;
  v[MARCH_TOTAL_INDICES] = in ? seg[3] : 0u;
  v[MARCH_TOTAL_CANDIDATES] = in ? march_segment_candidates(seg[0]) : 0u;
  v[MARCH_TOTAL_TILES] = in ? march_segment_tiles(seg[0]) : 0u;
}

// march_scan_kernel, a tile (a CTA) at a time, its threads in loops. Every
// tile first publishes its aggregates (as if all ran at once), then the
// tiles look back in ticket order or, `descending`, from the last (each
// walking every aggregate below it); then each tile's threads write their
// list rows, and the last tile the totals. Returns the tile records read.
extern "C" long long host_scan(const unsigned* rows, int nrows, int b,
                               const unsigned* records, int count_candidates,
                               int descending, int* list, long long* totals) {
  const int g = tiles_an_axis(b), segments = march_segments(g);
  const int tiles = march_scan_tiles(nrows), K = MARCH_TOTALS;
  std::vector<unsigned> sum((size_t)tiles * K, 0u);
  std::vector<unsigned long long> status((size_t)tiles * K), base(status);
  for (int tile = 0; tile < tiles; ++tile)
    for (int t = 0; t < MARCH_SCAN_THREADS; ++t) {
      unsigned v[MARCH_TOTALS];
      segment_counts(rows, nrows, tile * MARCH_SCAN_THREADS + t, v);
      for (int k = 0; k < K; ++k) sum[tile * K + k] += v[k];
    }
  for (int tile = 0; tile < tiles; ++tile)
    for (int k = 0; k < K; ++k)
      status[tile * K + k] = scan_word(
          tile == 0 ? SCAN_INCLUSIVE : SCAN_AGGREGATE, sum[tile * K + k]);
  for (int i = 0; i < tiles; ++i) {
    const int tile = descending ? tiles - 1 - i : i;
    for (int k = 0; k < K; ++k) {
      base[tile * K + k] = tile == 0 ? 0 : lookback(status.data() + k, K, tile);
      status[tile * K + k] =
          scan_word(SCAN_INCLUSIVE, base[tile * K + k] + sum[tile * K + k]);
    }
  }
  long long reads = 0;
  for (int tile = 0; tile < tiles; ++tile) {
    unsigned at[MARCH_TOTALS] = {0, 0, 0, 0, 0};  // the CTA's exclusive sums
    for (int t = 0; t < MARCH_SCAN_THREADS; ++t) {
      const int r = tile * MARCH_SCAN_THREADS + t;
      unsigned v[MARCH_TOTALS];
      segment_counts(rows, nrows, r, v);
      if (v[MARCH_TOTAL_TILES] != 0u) {
        const unsigned long long* bt = base.data() + tile * K;
        long long row_at = (long long)(bt[MARCH_TOTAL_TILES] + at[MARCH_TOTAL_TILES]);
        unsigned long long cells = bt[MARCH_TOTAL_CELLS] + at[MARCH_TOTAL_CELLS];
        unsigned long long vertices =
            bt[MARCH_TOTAL_VERTICES] + at[MARCH_TOTAL_VERTICES];
        unsigned long long indices =
            bt[MARCH_TOTAL_INDICES] + at[MARCH_TOTAL_INDICES];
        const int t0 = (r / segments) * g + (r % segments) * MARCH_ROW_TILES;
        const int n = imin(MARCH_ROW_TILES, g - (r % segments) * MARCH_ROW_TILES);
        for (int j = 0; j < n; ++j) {
          const unsigned x = records[2 * (t0 + j)], y = records[2 * (t0 + j) + 1];
          ++reads;
          const unsigned c = march_tile_cells(x);
          if (c == 0) continue;
          int* row = list + MARCH_LIST_WIDTH * row_at;
          row[MARCH_LIST_TILE] = t0 + j;
          row[MARCH_LIST_CELL_BASE] = (int)cells;
          row[MARCH_LIST_VERTEX_BASE] = (int)vertices;
          row[MARCH_LIST_INDEX_BASE] = (int)indices;
          row_at += 1;
          cells += c;
          vertices += march_tile_vertices(y);
          indices += march_tile_indices(y);
        }
      }
      for (int k = 0; k < K; ++k) at[k] += v[k];
    }
  }
  const int last = tiles - 1;
  for (int k = 0; k < K; ++k)
    totals[k] = k == MARCH_TOTAL_CANDIDATES && !count_candidates
                    ? 0
                    : (long long)(base[last * K + k] + sum[last * K + k]);
  return reads;
}

// march_emit_kernel, a listed tile (a warp) at a time, its lanes in loops.
extern "C" void host_emit(const float* field, int b, int rx, int ry, int rz,
                          const int* list, int march_tiles, long long m,
                          long long vertices, int* image) {
  const int g = tiles_an_axis(b);
  unsigned char* code_bytes = (unsigned char*)image + 4 * m;
  unsigned short* t16 = (unsigned short*)image + 2 * (m + (m + 3) / 4);
  if (march_tiles > 0) {
    for (long long p = m; p < 4 * ((m + 3) / 4); ++p) code_bytes[p] = 0;
    if (vertices & 1) t16[vertices] = 0;
  }
  const int nc = b - 1;
  float block[MARCH_TILE_CORNERS];
  unsigned bits[MARCH_SPAN * MARCH_SPAN];
  unsigned short cell_l[MARCH_TILE_CELLS];
  unsigned char owner[32 * MARCH_MAX_CELL_VERTICES];
  for (int r = 0; r < march_tiles; ++r) {
    const int* row = list + MARCH_LIST_WIDTH * r;
    const int t = row[MARCH_LIST_TILE];
    const int tx = t % g, ty = (t / g) % g, tz = t / (g * g);
    for (int k = 0; k < MARCH_TILE_CORNERS; ++k)
      block[k] = corner(field, b, tx * MARCH_TILE + k % MARCH_SPAN,
                        ty * MARCH_TILE + k / MARCH_SPAN % MARCH_SPAN,
                        tz * MARCH_TILE + k / (MARCH_SPAN * MARCH_SPAN));
    for (int k = 0; k < MARCH_SPAN * MARCH_SPAN; ++k) {
      unsigned v = 0;
      for (int x = 0; x < MARCH_SPAN; ++x) {
        const float c = block[k * MARCH_SPAN + x];
        v |= (march_sign_bit(c) << x) | (march_finite_bit(c) << (16 + x));
      }
      bits[k] = v;
    }
    // lanes 0-15: the cell words, ranked by a scan of their popcounts
    unsigned at = 0;
    for (int lane = 0; lane < MARCH_TILE_CELLS / 32; ++lane) {
      const int lz = lane / 2, ly0 = 4 * (lane % 2);
      unsigned sign[8], fin[8];
      for (int dz = 0; dz < 2; ++dz)
        for (int dy = 0; dy < 2; ++dy) {
          unsigned rows4[4];
          for (int i = 0; i < 4; ++i)
            rows4[i] = bits[(lz + dz) * MARCH_SPAN + ly0 + dy + i];
          for (int dx = 0; dx < 2; ++dx) {
            sign[dx + 2 * dy + 4 * dz] = march_row_bytes(rows4, dx);
            fin[dx + 2 * dy + 4 * dz] = march_row_bytes(rows4, 16 + dx);
          }
        }
      int nx = rx - tx * MARCH_TILE;
      nx = nx < 0 ? 0 : nx > MARCH_TILE ? MARCH_TILE : nx;
      const unsigned byte = (1u << nx) - 1u;
      unsigned region = 0;
      for (int i = 0; i < 4; ++i)
        if (ty * MARCH_TILE + ly0 + i < ry) region |= byte << (8 * i);
      if (tz * MARCH_TILE + lz >= rz) region = 0;
      const unsigned occ = march_word_occupied(sign, fin, region);
      for (int x = 0; x < 32; ++x)
        if ((occ >> x) & 1u) cell_l[at++] = (unsigned short)(32 * lane + x);
    }
    const unsigned tile_cells = at;
    const long long cell_base = row[MARCH_LIST_CELL_BASE];
    long long vertex_at = (unsigned)row[MARCH_LIST_VERTEX_BASE];
    for (unsigned first = 0; first < tile_cells; first += 32) {
      unsigned l[32], code[32], nv[32], excl[32], total = 0;
      for (int lane = 0; lane < 32; ++lane) {
        const unsigned i = first + lane;
        l[lane] = i < tile_cells ? cell_l[i] : 0;
        const int row0 = l[lane] / 64 * MARCH_SPAN + l[lane] / 8 % 8,
                  row1 = row0 + MARCH_SPAN;
        code[lane] = i < tile_cells
                         ? march_rows_code(bits[row0], bits[row0 + 1],
                                           bits[row1], bits[row1 + 1],
                                           l[lane] % 8)
                         : 0;
        nv[lane] = march_vertex_count(code[lane]);
        excl[lane] = total;
        total += nv[lane];
        if (i < tile_cells) {
          const int lx = l[lane] % 8, ly = l[lane] / 8 % 8, lz = l[lane] / 64;
          const int cx = tx * MARCH_TILE + lx, cy = ty * MARCH_TILE + ly,
                    cz = tz * MARCH_TILE + lz;
          image[cell_base + i] = (cz * nc + cy) * nc + cx;
          code_bytes[cell_base + i] = (unsigned char)code[lane];
        }
        march_spread_vertices(owner, excl[lane], nv[lane], lane);
      }
      for (unsigned v = 0; v < total; ++v) {
        const int o = owner[v];
        const unsigned e = march_vertex_end_offsets(
            &march_end_offsets_h[0][0], code[o], (int)(v - excl[o]));
        const int base = march_corner_index(l[o] % 8, l[o] / 8 % 8, l[o] / 64);
        t16[vertex_at + v] = (unsigned short)march_t16(
            block[base + (e & 0xFFu)], block[base + (e >> 8)]);
      }
      vertex_at += total;
    }
  }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """marching.cuh built for the host (g++ -ffp-contract=off: no FMA, as
    the kernels' _rn intrinsics), loaded with ctypes."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no C++ compiler to build marching.cuh for the host")
    d = tmp_path_factory.mktemp("marching_host")
    (d / "harness.cpp").write_text(_HARNESS)
    so = str(d / "libharness.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", CSRC, "-o", so,
                    str(d / "harness.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_tables.argtypes = [p, p, p, p]
    lib.host_check_masks.restype = i32
    lib.host_check_masks.argtypes = [p]
    lib.host_t16.argtypes = [p, p, i64, p]
    lib.host_segment_rows.restype = i32
    lib.host_segment_rows.argtypes = [i32]
    lib.host_run_tiles.restype = i32
    lib.host_run_tiles.argtypes = [i32]
    lib.host_classify.restype = i32
    lib.host_classify.argtypes = [p, i32, i32, i32, i32, i32, p, p]
    lib.host_scan.restype = i64
    lib.host_scan.argtypes = [p, i32, i32, p, i32, i32, p, p]
    lib.host_scan_state_words.restype = i32
    lib.host_scan_state_words.argtypes = [i32]
    lib.host_emit.argtypes = [p, i32, i32, i32, i32, p, i32, i64, i64, p]
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def host_image(lib, field, region, run_tiles=None, descending=False):
    """The three kernels run on the host as the wrapper runs them on the
    card: (image int32, totals by marching_cuda.TOTALS name, with the
    occupied-tile list and the tile records the scan read). Candidate
    tiles are counted above marching.TILED_ABOVE corners an axis.
    run_tiles: the classify warps' run along z (by default the launch's,
    march_run_tiles). descending: the scan's tiles look back from the
    last."""
    field = np.ascontiguousarray(field, np.float32)
    b = field.shape[0]
    g = -(-(b - 1) // marching.TILE)
    nrows = g * g * -(-g // marching_cuda.ROW_TILES)
    assert lib.host_segment_rows(b) == nrows
    if run_tiles is None:
        run_tiles = lib.host_run_tiles(b)
    # poisoned: a record the classify pass leaves unwritten shows
    records = np.full((g ** 3, 2), 0xFFFFFFFF, np.uint32)
    rows = np.full((nrows, 4), 0xFFFFFFFF, np.uint32)
    # a warp a column: a row segment by a band of 2 tiles by a run
    assert lib.host_classify(_ptr(field), b, *region, run_tiles,
                             _ptr(records), _ptr(rows)) == (
        nrows // g ** 2 * -(-g // 2) * -(-g // run_tiles))
    tile_list = np.empty((g ** 3, marching_cuda.LIST_WIDTH), np.int32)
    totals = np.empty(len(marching_cuda.TOTALS), np.int64)
    assert lib.host_scan_state_words(b) == marching_cuda.scan_state_words(g)
    reads = lib.host_scan(_ptr(rows), nrows, b, _ptr(records),
                          int(b > marching.TILED_ABOVE), int(descending),
                          _ptr(tile_list), _ptr(totals))
    t = dict(zip(marching_cuda.TOTALS, totals.tolist()))
    t.update(tile_list=tile_list, records_read=reads)
    words = block.CodesFormat(b - 1).total_words(t["cells"], t["vertices"])
    # a poisoned image: every byte the emission leaves unwritten shows
    image = np.full(words, -1, np.int32)
    lib.host_emit(_ptr(field), b, *region, _ptr(tile_list), t["tiles"],
                  t["cells"], t["vertices"], _ptr(image))
    return image, t


def _assert_counts(t, cm):
    assert (t["cells"], t["vertices"], t["indices"], t["candidates"]) == (
        cm.num_cells, cm.num_vertices, cm.num_indices, cm.num_tiles)


def test_header_tables_are_tables_py(host):
    """marching_tables.h is what ops/tables.py generates, and the host
    build reads EDGES, COUNT_TABLE and VERT_TABLE from it as tables.py
    has them, and the END_OFFSETS table as the corners EDGES[VERT_TABLE]
    at their offsets in a (9, 9, 9) corner block, off0 | off1 << 8 (0 past
    a code's vertices)."""
    with open(marching_cuda.TABLES_HEADER) as f:
        assert f.read() == marching_cuda.tables_header()
    assert host.host_num_edges() == tables.NUM_EDGES
    assert host.host_max_vertices() == tables.MAX_CELL_VERTICES
    edges = np.empty((tables.NUM_EDGES, 2), np.int32)
    counts = np.empty((256, 2), np.int32)
    verts = np.empty((256, tables.MAX_CELL_VERTICES), np.int32)
    offsets = np.empty((256, tables.MAX_CELL_VERTICES), np.int32)
    host.host_tables(_ptr(edges), _ptr(counts), _ptr(verts), _ptr(offsets))
    np.testing.assert_array_equal(edges, tables.EDGES)
    np.testing.assert_array_equal(counts, tables.COUNT_TABLE)
    np.testing.assert_array_equal(verts, tables.VERT_TABLE)
    block = np.arange(9 ** 3).reshape(9, 9, 9)  # [z, y, x]
    for code in range(256):
        for j in range(tables.MAX_CELL_VERTICES):
            e = tables.VERT_TABLE[code, j]
            want = 0
            if e >= 0:
                (x0, y0, z0), (x1, y1, z1) = (
                    marching.CORNER_OFFS[c] for c in tables.EDGES[e])
                want = block[z0, y0, x0] | block[z1, y1, x1] << 8
            assert offsets[code, j] == want
    np.testing.assert_array_equal(offsets,
                                  marching_cuda.vertex_end_offsets())


def test_mask_helpers_are_march_code_and_occupied(host):
    """The kernels' cell rule from corner bits (march_sign_bit,
    march_finite_bit, march_next_corners, march_row_bytes,
    march_word_occupied, march_word_code, march_rows_code) against the
    plain rule on the
    corner values (march_code, march_occupied), exhaustively: all 256 sign
    patterns with -0.0 and 0.0 among the corners >= 0, each corner in turn
    made NaN, +inf or -inf (+inf sets its sign bit and leaves the cell
    unoccupied), in and out of the region, at four places of classify's row
    words (one across the word's end) and four of emit's row bytes."""
    checks = ctypes.c_longlong(0)
    assert host.host_check_masks(ctypes.addressof(checks)) == 0
    assert checks.value == 256 * (1 + 8 * 3) * 2 * 8


@pytest.mark.parametrize("case", ["odd_37", "odd_21", "wide", "region_edges"])
@pytest.mark.parametrize("run_tiles", [2, 4, 8])
def test_host_build_with_longer_runs_is_the_plain_image(host, case,
                                                       run_tiles):
    """Classify's z-walk with runs longer than the small fields' launch
    takes (march_run_tiles gives 1 tile below ~300^3 corners), so that a
    warp walks several tile layers and the last run is shorter: the image
    and counts stay the plain ones."""
    field, region = field_case(case)
    want, cm = _plain(field, region)
    assert host.host_run_tiles(field.shape[0]) == 1
    got, t = host_image(host, field, region, run_tiles)
    _assert_counts(t, cm)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_host_build_equals_the_plain_image(host, case):
    field, region = field_case(case)
    want, cm = _plain(field, region)
    got, t = host_image(host, field, region)
    _assert_counts(t, cm)
    np.testing.assert_array_equal(got, want)
    if case in ("all_nan", "all_positive"):
        assert cm.num_cells == 0 and got.shape == (0,)
    elif case == "one_cell":
        assert cm.num_cells == 1
    else:
        assert cm.num_cells > 30


def _jax_image(field, region, tile_cap=0):
    """The JAX package's codes (eager, on the CPU) and the live prefix of
    its `_pack_codes` image, as tests/test_torch_marching.py runs them."""
    import jax
    import jax.numpy as jnp
    from mlsgpu_tpu.ops import marching as jmarch
    from mlsgpu_tpu.ops.block import _pack_codes
    # caps above the true counts (powers of two, from the plain version)
    cm = marching.generate_codes(torch.as_tensor(field), region)
    caps = dict(cell_cap=1 << max(cm.num_cells, 1).bit_length(),
                vertex_cap=1 << max(cm.num_vertices, 1).bit_length(),
                index_cap=3 << max(cm.num_indices // 3, 1).bit_length())
    cm = jmarch.generate(jnp.asarray(field), jnp.asarray(region, jnp.int32),
                         jnp.asarray((0, 0, 0), jnp.int32), **caps,
                         tile_cap=tile_cap, emit="codes")
    assert int(cm.num_cells) <= caps["cell_cap"]
    assert int(cm.num_vertices) <= caps["vertex_cap"]
    flat = np.asarray(jax.jit(_pack_codes, static_argnums=(1, 2))(
        cm, caps["cell_cap"], caps["vertex_cap"]))
    words = block.CodesFormat(0).total_words(int(cm.num_cells),
                                             int(cm.num_vertices))
    return flat[:words].view(np.int32), cm


def flush_subnormals(field):
    """The field as XLA's CPU backend reads it: subnormal values flushed
    to zero of their sign (so a negative subnormal corner is -0.0, which
    is outside)."""
    tiny = np.abs(field) < np.finfo(np.float32).tiny
    return np.where(tiny, np.copysign(np.float32(0.0), field), field)


@pytest.mark.parametrize("case", CASES)
def test_host_build_equals_the_jax_image(host, case):
    """The JAX package's image on the CPU, where XLA flushes subnormal
    floats to zero; torch, the plain version and the kernels keep them, so
    for the subnormal field the JAX image is the kernels' image of the
    flushed field (and differs from the unflushed one); so is the
    infinities field's."""
    field, region = field_case(case)
    want, cm = _jax_image(field, region)
    if case == "subnormal":
        unflushed, _ = host_image(host, field, region)
        assert not np.array_equal(unflushed, want)
    if case in ("subnormal", "infinities"):
        field = flush_subnormals(field)
    got, t = host_image(host, field, region)
    assert (t["cells"], t["vertices"], t["indices"], t["candidates"]) == (
        int(cm.num_cells), int(cm.num_vertices), int(cm.num_indices), 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["sphere", "region_edges", "noise", "wide",
                                  "odd_37"])
def test_tiled_rule_counts_candidate_tiles(host, monkeypatch, case):
    """Above marching.TILED_ABOVE corners an axis the counts carry the
    candidate tiles of tiled classification (the JAX package's num_tiles
    with a tile cap); at or below it 0, as dense classification reports.
    The threshold is lowered here rather than a > 256^3 field built."""
    field, region = field_case(case)
    b = field.shape[0]
    g = -(-(b - 1) // marching.TILE)
    monkeypatch.setattr(marching, "TILED_ABOVE", b - 1)
    want, cm = _plain(field, region)
    got, t = host_image(host, field, region)
    assert cm.num_tiles > 0
    _assert_counts(t, cm)
    np.testing.assert_array_equal(got, want)
    jwant, jcm = _jax_image(field, region, tile_cap=g ** 3)
    assert int(jcm.num_tiles) == t["candidates"]
    np.testing.assert_array_equal(got, jwant)
    img, counts = marching_cuda.codes_image(torch.as_tensor(field), region)
    assert counts.num_tiles == t["candidates"]
    np.testing.assert_array_equal(img.numpy(), want)
    monkeypatch.setattr(marching, "TILED_ABOVE", b)
    _, t = host_image(host, field, region)
    assert t["candidates"] == 0


@pytest.mark.parametrize("case", CASES)
def test_scan_bound_counts_the_records_the_scan_reads(host, case):
    """chip_smoke.marching_bound charges the scan its segment records, the
    tile records of the segments with an occupied tile (segment_tiles,
    from the list: what the host scan reads, no more) and its list rows
    and totals."""
    import chip_smoke
    field, region = field_case(case)
    b = field.shape[0]
    _, t = host_image(host, field, region)
    marched = marching_cuda.Marched(
        counts=marching_cuda.MarchCounts(t["cells"], t["vertices"],
                                         t["indices"], t["candidates"]),
        field=torch.as_tensor(field), region=region,
        tile_list=torch.as_tensor(t["tile_list"]), march_tiles=t["tiles"])
    reads = chip_smoke.segment_tiles(marched)
    assert reads == t["records_read"]
    assert (reads == 0) == (t["tiles"] == 0)
    nrows = host.host_segment_rows(b)
    bound = chip_smoke.marching_bound("march_scan", b, t["tiles"], reads,
                                      t["vertices"], 0)
    assert bound["bytes"] == (16 * nrows + 8 * reads + 16 * t["tiles"]
                              + 8 * len(marching_cuda.TOTALS))


def random_records(b, occupied, seed):
    """(records (g^3, 2) uint32, rows (segments, 4) uint32) as the
    classify pass writes them, made up from a numpy seed: a tile has an
    occupied cell with probability `occupied` (1-512 cells, up to 12
    vertices and 15 indices a cell), is a candidate with probability 1/2
    (always when occupied), and each row segment holds its tiles' sums."""
    rng = np.random.default_rng(seed)
    g = -(-(b - 1) // marching.TILE)
    n = g ** 3
    cells = np.where(rng.random(n) < occupied, rng.integers(1, 513, n), 0)
    vertices = np.where(cells > 0, rng.integers(0, 12 * cells + 1), 0)
    indices = np.where(cells > 0, rng.integers(0, 15 * cells + 1), 0)
    cand = (cells > 0) | (rng.random(n) < 0.5)
    records = np.empty((n, 2), np.uint32)
    records[:, 0] = cells | cand.astype(np.uint32) << 16
    records[:, 1] = vertices | indices << 16
    per = marching_cuda.ROW_TILES
    segs = -(-g // per)
    seg = (np.arange(n) % g) // per + np.arange(n) // g * segs
    rows = np.zeros((g * g * segs, 4), np.uint64)
    for col, val in ((0, (cells > 0) + (cand.astype(np.uint64) << 16)),
                     (1, cells), (2, vertices), (3, indices)):
        np.add.at(rows[:, col], seg, val.astype(np.uint64))
    return records, rows.astype(np.uint32)


def plain_scan(records, count_candidates):
    """The scan's list (occupied tiles in order: tile, cell base, vertex
    base, index base) and totals (marching_cuda.TOTALS order) from the
    tile records, in numpy."""
    cells = (records[:, 0] & 0xFFFF).astype(np.int64)
    vertices = (records[:, 1] & 0xFFFF).astype(np.int64)
    indices = (records[:, 1] >> 16).astype(np.int64)
    occ = np.flatnonzero(cells)
    lst = np.zeros((len(occ), marching_cuda.LIST_WIDTH), np.int64)
    lst[:, 0] = occ
    lst[:, 1] = np.cumsum(cells[occ]) - cells[occ]
    lst[:, 2] = np.cumsum(vertices[occ]) - vertices[occ]
    lst[:, 3] = np.cumsum(indices[occ]) - indices[occ]
    cand = int((records[:, 0] >> 16).astype(np.int64).sum())
    totals = [int(cells.sum()), int(vertices.sum()),
              int((records[:, 1] >> 16).astype(np.int64).sum()),
              cand if count_candidates else 0, len(occ)]
    return lst.astype(np.int32), totals


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("b,occupied", [(2, 1.0), (77, 0.3), (300, 0.05),
                                        (600, 0.01), (1024, 0.002),
                                        (1024, 1.0)])
def test_host_scan_is_a_plain_scan_of_the_records(host, b, occupied,
                                                  descending):
    """The scan kernel run on the host tile by tile, its look-back in
    ticket order and in reverse (each tile walking every aggregate below
    it), on records made up for every size up to b = 1024 (1,024 scan
    tiles; every tile occupied too): the list and the totals a plain
    numpy scan of the records gives."""
    records, rows = random_records(b, occupied, seed=b)
    g = -(-(b - 1) // marching.TILE)
    tile_list = np.full((g ** 3, marching_cuda.LIST_WIDTH), -1, np.int32)
    totals = np.empty(len(marching_cuda.TOTALS), np.int64)
    count = int(b > marching.TILED_ABOVE)
    reads = host.host_scan(_ptr(rows), len(rows), b, _ptr(records), count,
                           int(descending), _ptr(tile_list), _ptr(totals))
    want_list, want_totals = plain_scan(records, count)
    assert totals.tolist() == want_totals
    np.testing.assert_array_equal(tile_list[:len(want_list)], want_list)
    assert (tile_list[len(want_list):] == -1).all()
    assert reads >= len(want_list) > 0


@pytest.mark.parametrize("case", ["sphere", "region_edges", "wide",
                                  "every_tile"])
def test_plain_list_is_the_host_scan_list(host, case):
    """plain_list, which the card's scan test holds the kernel's list to,
    is the host scan's list on the same field (every_tile_field: each of
    its tiles listed)."""
    if case == "every_tile":
        field, region = every_tile_field(41, "cpu").numpy(), (40, 40, 40)
    else:
        field, region = field_case(case)
    _, t = host_image(host, field, region)
    cm = marching.generate_codes(torch.as_tensor(field), region)
    want = plain_list(cm, field.shape[0]).numpy()
    assert t["tiles"] == len(want) > 0
    np.testing.assert_array_equal(t["tile_list"][:len(want)], want)


def test_t16_is_torchs_rounding(host):
    """march_t16 against the plain version's torch ops on edge values:
    subnormal corners and differences, exact zeros of both signs on the
    outside end, huge values whose difference overflows, and t at the
    halves where rounding goes to even."""
    rng = np.random.default_rng(2)
    f32 = np.float32
    tiny = f32([1e-45, 2e-45, 3e-45, 1e-44, 1e-41, 5e-39, 1.1754942e-38,
                1.1754944e-38])
    outside = np.concatenate([
        tiny, f32([0.0, -0.0, 1.0, 3e38, 3.4028235e38, 0.5, 1e-7]),
        (rng.random(400) * np.exp2(rng.integers(-140, 120, 400))).astype(f32)])
    inside = -np.concatenate([
        tiny, f32([1.0, 3e38, 3.4028235e38, 0.5, 1e-7]),
        (rng.random(400) * np.exp2(rng.integers(-140, 120, 400))).astype(f32)])
    inside = inside[inside < 0]
    # t = k / 65535 + half a step: k + 0.5 rounds to even
    k = np.arange(0, 65535, 97, dtype=np.float64)
    half_a = ((k + 0.5) / 65535).astype(f32)
    a = np.concatenate([np.repeat(outside, len(inside)),
                        np.tile(inside, len(outside)), half_a])
    b = np.concatenate([np.tile(inside, len(outside)),
                        np.repeat(outside, len(inside)),
                        (half_a - 1).astype(f32)])
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    t = ta / (ta - tb)
    want = torch.clamp(torch.round(t * 65535.0), 0, 65535).to(torch.int64)
    got = np.empty(len(a), np.uint32)
    host.host_t16(_ptr(a), _ptr(b), len(a), _ptr(got))
    np.testing.assert_array_equal(got.astype(np.int64), want.numpy())


# --- the wrapper on the CPU ---------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_codes_image_on_cpu_is_the_plain_image(case):
    field, region = field_case(case)
    want, cm = _plain(field, region)
    before = launches.counts()
    img, counts = marching_cuda.codes_image(torch.as_tensor(field), region)
    assert launches.counts() == before
    assert img.dtype == torch.int32
    np.testing.assert_array_equal(img.numpy(), want)
    assert counts == marching_cuda.MarchCounts(
        cm.num_cells, cm.num_vertices, cm.num_indices, cm.num_tiles)


def test_codes_image_raises_for_a_device_it_cannot_take():
    """A meta tensor raises; classify and launch_classify, which only
    launch, take CUDA tensors alone."""
    field, region = field_case("sphere")
    with pytest.raises(ValueError, match="meta"):
        marching_cuda.codes_image(torch.as_tensor(field).to("meta"), region)
    with pytest.raises(ValueError, match="cpu"):
        marching_cuda.launch_classify(torch.as_tensor(field), region)
    with pytest.raises(ValueError, match="cpu"):
        marching_cuda.classify(torch.as_tensor(field), region)


def test_block_step_counts_on_cpu_carry_n_occ():
    """The codes branch of block_step on the CPU: the counts in
    COUNTS_FIELDS order, n_occ from the field, the plain image."""
    rng = np.random.default_rng(9)
    v = rng.normal(size=(3000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    s = np.zeros((3000, 8), np.float32)
    s[:, 0:3] = 14.0 + 9.0 * v
    s[:, 3] = 1.5
    s[:, 4:7] = v
    s[:, 7] = 1.0
    res = block.block_step(torch.as_tensor(s), torch.ones(3000,
                                                          dtype=torch.bool),
                           (31, 31, 31), (0, 0, 0), 0.0, levels=3,
                           subsampling=3, readback="codes")
    field, n_occ = block.block_field(
        torch.as_tensor(s), torch.ones(3000, dtype=torch.bool), (31, 31, 31),
        (0, 0, 0), 0.0, levels=3, subsampling=3)
    cm = marching.generate_codes(field, (31, 31, 31))
    assert res.counts.tolist() == [cm.num_vertices, 0, cm.num_indices, 0,
                                   cm.num_cells, cm.num_vertices, int(n_occ),
                                   cm.num_tiles]
    assert int(n_occ) > 0 and cm.num_cells > 100
    assert torch.equal(res.packed, block.pack_codes(cm))


@pytest.mark.parametrize("levels", [6, 7])
def test_card_codes_estimate_counts_the_kernels_buffers(levels):
    """pipeline/resources.py on the card's codes readback counts the
    marching kernels' buffers (tile and segment records, the scan's state,
    the list, the totals, the image) and not the plain path's
    classification and emission temporaries; the card's packed and raw
    readbacks count their kernels' buffers (tests/test_torch_mesh_cuda.py
    holds their sizes) and no plain term; the CPU keeps the plain
    figures in every readback."""
    from mlsgpu_tpu_torch.pipeline import resources
    from mlsgpu_tpu_torch.tools import cloud
    cfg = cloud.bench_config(0.03, levels)
    b = 1 << cfg.device_shift
    g = -(-(b - 1) // marching.TILE)
    occ = int((b - 1) ** 3 * resources.SURFACE_CELL_SHARE)
    card = resources.estimate_block_usage(cfg, "codes", "cuda")
    rows = g * g * -(-g // 8)
    scan_tiles = -(-rows // 256)
    assert card["marching_kernels"] == (
        8 * g ** 3 + 16 * rows + 16 * g ** 3
        + 8 * (1 + 5 * scan_tiles) + 8 * len(marching_cuda.TOTALS)
        + 4 * block.CodesFormat(b - 1).total_words(occ, 4 * occ))
    plain = ("marching_tiled" if b > marching.TILED_ABOVE
             else "marching_dense")
    assert plain not in card and "emission" not in card
    mesh_plain = ("mesh", "weld", "pack")
    for readback in ("codes", "packed", "raw"):
        usage = resources.estimate_block_usage(cfg, readback, "cpu")
        assert "marching_kernels" not in usage
        assert usage[plain] > 0 and usage["emission"] > 0
        assert all((k in usage) == (readback != "codes"
                                    and (k != "pack" or readback == "packed"))
                   for k in mesh_plain)
    for readback in ("packed", "raw"):
        usage = resources.estimate_block_usage(cfg, readback, "cuda")
        assert usage["marching_kernels"] > card["marching_kernels"]
        assert usage["weld_kernels"] > 0 and usage["pack_kernels"] > 0
        assert not {plain, "emission", *mesh_plain} & set(usage)
    cpu = resources.estimate_block_usage(cfg, "codes", "cpu")
    assert card["marching_kernels"] < cpu[plain] + cpu["emission"]
    assert card["total"] == sum(v for k, v in card.items() if k != "total")


def test_bench_marching_takes_each_kernels_median():
    """tools/bench_marching's kernels-alone time: each kernel's median over
    its kernel events (host events of the same name do not count), None for
    a kernel whose trace lost events (fewer than one a call); its timing
    helpers come from tools/bench_binning.py by file."""
    from mlsgpu_tpu_torch.tools import bench_marching
    events = [
        {"ph": "X", "cat": "kernel", "dur": d,
         "name": "(anonymous namespace)::march_classify_kernel(int)"}
        for d in (40.0, 44.0, 90.0)] + [
        {"ph": "X", "cat": "kernel", "dur": 9.0, "name": "march_scan_kernel"},
        {"ph": "X", "cat": "cpu_op", "dur": 500.0,
         "name": "march_emit_kernel"}]
    got = bench_marching.kernel_medians(events, bench_marching.KERNELS, 3)
    assert got == {"march_classify_kernel": pytest.approx(0.044),
                   "march_scan_kernel": None, "march_emit_kernel": None}
    timing = bench_marching.timing_helpers()
    assert callable(timing.event_ms) and callable(timing.trace_events)


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the marching kernels have no CPU "
                    "mode)")
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


def _since(before):
    now = launches.since(before)
    return [now[k] for k in MARCHING]


def _plain_on_card(field, region):
    cm = marching.generate_codes(field, region)
    return block.pack_codes(cm), cm


@pytest.mark.cuda
@pytest.mark.parametrize("b", [256, 512, 77, 300, 600])
def test_kernels_bit_for_bit_on_card(cuda_device, b):
    """At 256^3 and 512^3 (classify runs of 1 and 2 tiles), and at sizes
    that are not multiples of 4 or of a tile's 8 cells: 77 (10 tiles an
    axis, a row segment of 2; rows that start off a 16-byte boundary), 300
    (38: a band of one tile row) and 600 (75: runs of 2 with a last run of
    1)."""
    field = card_field(b, cuda_device)
    region = (b - 1, b - 9, b - 3)
    n_occ = torch.tensor(11, dtype=torch.int32, device=cuda_device)
    before = launches.counts()
    marched = marching_cuda.classify(field, region, n_occ)
    img = marching_cuda.emit(marched)
    assert _since(before) == [1, 1, 1]
    want, cm = _plain_on_card(field, region)
    torch.cuda.synchronize()
    assert marched.counts == marching_cuda.MarchCounts(
        cm.num_cells, cm.num_vertices, cm.num_indices, cm.num_tiles)
    assert marched.n_occ == 11
    assert cm.num_cells > (10_000 if b >= 256 else 1_000)
    assert (cm.num_tiles > 0) == (b > marching.TILED_ABOVE)
    assert img.shape == want.shape and torch.equal(img, want)


def every_tile_field(b, dev):
    """A (b, b, b) field with an occupied cell in every tile: 1.0 but for
    the corner (8i + 4, 8j + 4, 8k + 4) of each tile (or its last corner
    where the tile is shorter), -1.0, so that the eight cells around it,
    all in that tile, are occupied."""
    field = torch.ones((b, b, b), dtype=torch.float32, device=dev)
    g = -(-(b - 1) // marching.TILE)
    at = torch.clamp(torch.arange(g, device=dev) * marching.TILE + 4,
                     max=b - 2)
    field[at[:, None, None], at[None, :, None], at[None, None, :]] = -1.0
    return field


def plain_list(cm, b):
    """The scan's list (tile, cell base, vertex base, index base) of a
    block's plain codes (marching.generate_codes): the tiles of its
    occupied cells in order, each tile's first cell and the vertices and
    triangle indices before it."""
    nc = b - 1
    g = -(-nc // marching.TILE)
    ids = cm.cell_ids
    t = marching.TILE
    tile = ((ids // (nc * nc) // t) * g + ids // nc % nc // t) * g \
        + ids % nc // t
    counts = torch.as_tensor(tables.COUNT_TABLE, device=ids.device)[
        cm.cell_codes]
    base = torch.cumsum(counts, 0) - counts
    first = torch.ones_like(tile, dtype=torch.bool)
    first[1:] = tile[1:] != tile[:-1]
    at = first.nonzero().squeeze(1)
    return torch.stack([tile[at], at, base[at, 0], base[at, 1]],
                       1).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("b,every_tile", [
    (2, False), (77, False), (256, False), (300, False), (512, False),
    (600, False), (1024, False), (1024, True)])
def test_scan_bit_for_bit_on_card(cuda_device, b, every_tile):
    """The scan kernel's list and totals (launch_classify) are the plain
    stage's bit for bit (the tiles of marching.generate_codes' cells, their
    cell and vertex bases, its counts) at every size from 2 to 1024 corners
    an axis (1 to 1,024 scan tiles), and at 1024 with every tile occupied
    (2,097,152 listed tiles); the image too."""
    field = (every_tile_field(b, cuda_device) if every_tile
             else card_field(b, cuda_device))
    region = (b - 1,) * 3
    tile_list, totals = marching_cuda.launch_classify(field, region)
    t = dict(zip(marching_cuda.TOTALS, totals.tolist()))
    cm = marching.generate_codes(field, region)
    assert (t["cells"], t["vertices"], t["indices"], t["candidates"]) == (
        cm.num_cells, cm.num_vertices, cm.num_indices, cm.num_tiles)
    want = plain_list(cm, b)
    assert t["tiles"] == want.shape[0]
    assert torch.equal(tile_list[:t["tiles"]], want)
    if every_tile:
        assert t["tiles"] == (-(-(b - 1) // marching.TILE)) ** 3
    img, _ = marching_cuda.codes_image(field, region)
    assert torch.equal(img, block.pack_codes(cm))


@pytest.mark.cuda
def test_empty_field_on_card(cuda_device):
    field = torch.full((256, 256, 256), float("nan"), device=cuda_device)
    before = launches.counts()
    img, counts = marching_cuda.codes_image(field, (255, 255, 255))
    assert _since(before) == [1, 1, 0]
    assert img.shape == (0,) and img.device.type == "cuda"
    assert counts == marching_cuda.MarchCounts(0, 0, 0, 0)


@pytest.mark.cuda
def test_two_streams_at_once_on_card(cuda_device):
    """Two images and two radix sorts (ops/binning_cuda.py, on the same
    look-back scan as the marching scan) on two streams of the card at the
    same time, three rounds interleaved: all finish within 60 s (a CTA of
    either waits only on CTAs that took their tickets before it, so
    launches sharing the card in any proportion make progress), each image
    bit for bit its plain image and each sort torch.sort(stable=True)'s."""
    import time
    from mlsgpu_tpu_torch.ops import binning, binning_cuda
    fields = [card_field(256, cuda_device, seed=s) for s in (1, 2)]
    region = (255, 255, 255)
    want = [_plain_on_card(f, region)[0] for f in fields]
    rng = np.random.default_rng(4)
    top = binning.node_count(3, 9)
    keys = []
    for m in (663_496, 3_098_216):
        k = rng.integers(0, top, size=m)
        k[rng.random(m) < 0.6] = binning.INVALID_KEY
        keys.append(torch.as_tensor(k, device=cuda_device))
    want_sorts = [torch.sort(k, stable=True) for k in keys]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in fields]
    got = [[None] * 3 for _ in streams]
    sorts = [[None] * 3 for _ in streams]
    for r in range(3):
        marched = [None, None]
        for i, (f, s) in enumerate(zip(fields, streams)):
            s.wait_stream(torch.cuda.current_stream(cuda_device))
            with torch.cuda.stream(s):
                sorts[i][r] = binning_cuda.sort_keys(keys[i], 3, 9)
                marched[i] = marching_cuda.classify(f, region)
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i][r] = marching_cuda.emit(marched[i])
                sorts[i][r] = sorts[i][r] + binning_cuda.sort_keys(
                    keys[1 - i], 3, 9)
    done = [torch.cuda.Event() for _ in streams]
    for ev, s in zip(done, streams):
        ev.record(s)
    deadline = time.monotonic() + 60.0
    while not all(ev.query() for ev in done):
        assert time.monotonic() < deadline, "two streams did not finish"
        time.sleep(0.001)
    for i in range(2):
        for r in range(3):
            assert torch.equal(got[i][r], want[i])
            k0, p0, k1, p1 = sorts[i][r]
            for gk, gp, (wk, wp) in ((k0, p0, want_sorts[i]),
                                     (k1, p1, want_sorts[1 - i])):
                assert torch.equal(gk, wk) and torch.equal(gp, wp)


@pytest.mark.cuda
def test_one_sync_a_call_on_card(cuda_device):
    """A traced call issues the three kernels and at most one sync (the
    totals' copy)."""
    import json
    import tempfile
    import torch.profiler as tp
    from mlsgpu_tpu_torch.utils import step_profile
    field = card_field(256, cuda_device)
    marching_cuda.codes_image(field, (255, 255, 255))
    torch.cuda.synchronize()
    with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                tp.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with tp.record_function(step_profile.STEP):
                marching_cuda.codes_image(field, (255, 255, 255))
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            summary = step_profile.summarize(json.load(f))
    assert summary["launches"] == 3
    assert summary["sync_calls"] <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [6, 7])
def test_codes_estimate_holds_the_stage_on_card(cuda_device, levels):
    """The card's codes estimate (pipeline/resources.py) holds what one
    codes stage allocates on a block's field at 256^3 and 512^3: the peak
    of torch.cuda.max_memory_allocated above the field."""
    from mlsgpu_tpu_torch.pipeline import resources
    from mlsgpu_tpu_torch.tools import cloud
    cfg = cloud.bench_config(0.03, levels)
    b = 1 << cfg.device_shift
    usage = resources.estimate_block_usage(cfg, "codes", "cuda")
    field = card_field(b, cuda_device)
    assert field.numel() * field.element_size() <= usage["field"]
    torch.cuda.synchronize(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    img, counts = marching_cuda.codes_image(field, (b - 1,) * 3)
    torch.cuda.synchronize(cuda_device)
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert counts.num_cells > 10_000 and img.numel() > 0
    assert 0 < peak <= usage["marching_kernels"]
