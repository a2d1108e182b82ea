"""The codes path's marching kernels (ops/marching_cuda.py,
csrc/marching.cu).

On the CPU: the kernels' arithmetic (csrc/marching.cuh) built for the host
with g++ -ffp-contract=off, with host loops that run the three kernels CTA
by CTA (classify a row segment of eight tiles a CTA, the scan a range of
segments a thread, emit a listed tile a CTA, writing bytes and halfwords
into the image), held bit
for bit, image and counts, to the plain `block.pack_codes(
marching.generate_codes(...))` and to the JAX package's
`generate(emit="codes")` + `_pack_codes` live prefix, on fields made from a
numpy seed: a sphere, region edges that are not multiples of 8, a block
of 10 tiles an axis (two row segments of the classify pass), all NaN
(an empty image), all positive, one bipolar cell, exact 0.0 and -0.0
corners, subnormal differences, and the tiled rule's candidate tiles
(marching.TILED_ABOVE lowered rather than a > 256^3 field built); t16
against torch's formula on edge values; the header's tables against
ops/tables.py; the wrapper on CPU tensors (the plain image, no launch) and
on a device it cannot take (raises). On the card (marker `cuda`): the
kernels' image bit for bit the plain one at 256^3 and 512^3, an empty
field, two images on two streams at once, one launch of each kernel and
at most one sync a call.

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
    if name == "noise":
        # a dense random field: most cells cut, many tiles full
        f = rng.normal(size=(40, 40, 40)).astype(np.float32)
        f[rng.random(f.shape) < 0.05] = np.nan
        return f, (39, 33, 38)
    raise KeyError(name)


CASES = ("sphere", "region_edges", "all_nan", "all_positive", "one_cell",
         "zeros", "subnormal", "noise", "wide")


def _plain(field, region, tiled=None):
    """The plain image (int32 numpy) and counts."""
    cm = marching.generate_codes(torch.as_tensor(field), region, tiled=tiled)
    return block.pack_codes(cm).numpy(), cm


# --- the kernels' arithmetic, built for the host ------------------------------

# The kernels' bodies (csrc/marching.cu) as host loops over marching.cuh:
# classify a row segment of MARCH_ROW_TILES tiles a CTA (its corners as one
# block of MARCH_ROW_PITCH), the scan a contiguous range of segments a
# thread, each thread's bases the sums of the threads before it, emit a
# tile a CTA (a thread a cell, raster order).
_HARNESS = """
#include <math.h>
#include <string.h>

#include "marching.cuh"

extern "C" int host_num_edges() { return MARCH_NUM_EDGES; }
extern "C" int host_max_vertices() { return MARCH_MAX_CELL_VERTICES; }

extern "C" void host_tables(int* edges, int* counts, int* verts) {
  for (int e = 0; e < MARCH_NUM_EDGES; ++e)
    for (int k = 0; k < 2; ++k) edges[2 * e + k] = march_edges_h[e][k];
  for (int c = 0; c < 256; ++c) {
    counts[2 * c] = (int)march_vertex_count(c);
    counts[2 * c + 1] = (int)march_index_count(c);
    for (int j = 0; j < MARCH_MAX_CELL_VERTICES; ++j)
      verts[c * MARCH_MAX_CELL_VERTICES + j] = march_verts_h[c][j];
  }
}

extern "C" void host_t16(const float* iso0, const float* iso1, long long n,
                         unsigned* t16) {
  for (long long i = 0; i < n; ++i) t16[i] = march_t16(iso0[i], iso1[i]);
}

// The (9, 9, pitch) corners from (x0, y0, z0), NaN past the field's end.
static void stage(const float* field, int b, int x0, int y0, int z0,
                  int pitch, float* block) {
  for (int k = 0; k < MARCH_SPAN * MARCH_SPAN * pitch; ++k) {
    const int x = x0 + k % pitch, y = y0 + (k / pitch) % MARCH_SPAN,
              z = z0 + k / (pitch * MARCH_SPAN);
    block[k] = x < b && y < b && z < b ? field[((long long)z * b + y) * b + x]
                                       : NAN;
  }
}

static int tiles_an_axis(int b) { return (b - 1 + MARCH_TILE - 1) / MARCH_TILE; }

static int row_segments(int g) {
  return (g + MARCH_ROW_TILES - 1) / MARCH_ROW_TILES;
}

extern "C" int host_segment_rows(int b) {
  const int g = tiles_an_axis(b);
  return g * g * row_segments(g);
}

// march_classify_kernel, a CTA (a row segment of MARCH_ROW_TILES tiles) at
// a time.
extern "C" int host_classify(const float* field, int b, int rx, int ry, int rz,
                             unsigned* records, unsigned* rows) {
  const int g = tiles_an_axis(b), segments = row_segments(g);
  const int nrows = g * g * segments;
  static float block[MARCH_SPAN * MARCH_SPAN * MARCH_ROW_PITCH];
  for (int r = 0; r < nrows; ++r) {
    const int seg = r % segments, row = r / segments;
    const int ty = row % g, tz = row / g, tx0 = seg * MARCH_ROW_TILES;
    const int n = g - tx0 < MARCH_ROW_TILES ? g - tx0 : MARCH_ROW_TILES;
    stage(field, b, tx0 * MARCH_TILE, ty * MARCH_TILE, tz * MARCH_TILE,
          MARCH_ROW_PITCH, block);
    unsigned tc[MARCH_ROW_TILES] = {0}, tn[MARCH_ROW_TILES] = {0};
    for (int lz = 0; lz < MARCH_TILE; ++lz)
      for (int ly = 0; ly < MARCH_TILE; ++ly)
        for (int lx = 0; lx < MARCH_ROW_TILES * MARCH_TILE; ++lx) {
          float c[8];
          march_cell_corners(
              block + march_corner_index(lx, ly, lz, MARCH_ROW_PITCH),
              MARCH_ROW_PITCH, c);
          const unsigned code = march_code(c);
          const bool occupied = march_occupied(
              c, code, tx0 * MARCH_TILE + lx < rx && ty * MARCH_TILE + ly < ry &&
                           tz * MARCH_TILE + lz < rz);
          const int j = lx / MARCH_TILE;
          tc[j] += (occupied ? 1u : 0u) | (isfinite(c[0]) ? 1u << 16 : 0u);
          if (occupied)
            tn[j] += march_vertex_count(code) | (march_index_count(code) << 16);
        }
    unsigned sum[4] = {0, 0, 0, 0};
    for (int j = 0; j < n; ++j) {
      const unsigned x = march_tile_cells(tc[j]) |
                         (march_tile_candidate(tc[j]) ? 1u << 16 : 0u);
      records[2 * (row * g + tx0 + j)] = x;
      records[2 * (row * g + tx0 + j) + 1] = tn[j];
      sum[0] += (march_tile_cells(x) > 0 ? 1u : 0u) |
                (march_tile_candidate(x) ? 1u << 16 : 0u);
      sum[1] += march_tile_cells(x);
      sum[2] += march_tile_vertices(tn[j]);
      sum[3] += march_tile_indices(tn[j]);
    }
    for (int k = 0; k < 4; ++k) rows[4 * r + k] = sum[k];
  }
  return g * g * g;
}

// march_scan_kernel: thread i's contiguous segments, its bases the sums of
// the threads before it. Returns the tile records it read.
extern "C" long long host_scan(const unsigned* rows, int nrows, int b,
                          const unsigned* records, int count_candidates,
                          int* list, long long* totals) {
  const int g = tiles_an_axis(b), segments = row_segments(g);
  const int per = (nrows + MARCH_SCAN_THREADS - 1) / MARCH_SCAN_THREADS;
  unsigned at[3] = {0, 0, 0};
  unsigned long long vertices = 0, indices = 0, candidates = 0;
  long long reads = 0;
  for (int i = 0; i < MARCH_SCAN_THREADS; ++i) {
    const int first = i * per < nrows ? i * per : nrows;
    const int last = first + per < nrows ? first + per : nrows;
    for (int r = first; r < last; ++r) {
      const unsigned* seg = rows + 4 * r;
      vertices += seg[2];
      indices += seg[3];
      candidates += march_segment_candidates(seg[0]);
      if (march_segment_tiles(seg[0]) == 0) continue;
      const int t0 = (r / segments) * g + (r % segments) * MARCH_ROW_TILES;
      const int left = g - (r % segments) * MARCH_ROW_TILES;
      const int n = left < MARCH_ROW_TILES ? left : MARCH_ROW_TILES;
      for (int j = 0; j < n; ++j) {
        const unsigned x = records[2 * (t0 + j)], y = records[2 * (t0 + j) + 1];
        ++reads;
        const unsigned cells = march_tile_cells(x);
        if (cells == 0) continue;
        int* row = list + MARCH_LIST_WIDTH * at[0];
        row[MARCH_LIST_TILE] = t0 + j;
        row[MARCH_LIST_CELL_BASE] = (int)at[1];
        row[MARCH_LIST_VERTEX_BASE] = (int)at[2];
        row[3] = 0;
        at[0] += 1;
        at[1] += cells;
        at[2] += march_tile_vertices(y);
      }
    }
  }
  totals[MARCH_TOTAL_CELLS] = at[1];
  totals[MARCH_TOTAL_VERTICES] = (long long)vertices;
  totals[MARCH_TOTAL_INDICES] = (long long)indices;
  totals[MARCH_TOTAL_CANDIDATES] = count_candidates ? (long long)candidates : 0;
  totals[MARCH_TOTAL_TILES] = at[0];
  return reads;
}

// march_emit_kernel, a listed tile at a time: the CTA's scan of
// (occupied, vertices) in thread order, then each cell's bytes.
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
  float block[MARCH_TILE_CORNERS];
  for (int r = 0; r < march_tiles; ++r) {
    const int* row = list + MARCH_LIST_WIDTH * r;
    const int t = row[MARCH_LIST_TILE];
    const int tx = t % g, ty = (t / g) % g, tz = t / (g * g);
    stage(field, b, tx * MARCH_TILE, ty * MARCH_TILE, tz * MARCH_TILE,
          MARCH_SPAN, block);
    unsigned excl = 0;
    for (int l = 0; l < MARCH_TILE_CELLS; ++l) {
      const int lx = l % MARCH_TILE, ly = (l / MARCH_TILE) % MARCH_TILE,
                lz = l / (MARCH_TILE * MARCH_TILE);
      const float* base = block + march_corner_index(lx, ly, lz, MARCH_SPAN);
      float c[8];
      march_cell_corners(base, MARCH_SPAN, c);
      const unsigned code = march_code(c);
      const int cx = tx * MARCH_TILE + lx, cy = ty * MARCH_TILE + ly,
                cz = tz * MARCH_TILE + lz;
      const bool occupied =
          march_occupied(c, code, cx < rx && cy < ry && cz < rz);
      const unsigned nv = occupied ? march_vertex_count(code) : 0u;
      if (occupied) {
        const long long at = (long long)row[MARCH_LIST_CELL_BASE] +
                             (excl & 0xFFFFu);
        const int nc = b - 1;
        image[at] = (cz * nc + cy) * nc + cx;
        code_bytes[at] = (unsigned char)code;
        unsigned short* out =
            t16 + (unsigned)row[MARCH_LIST_VERTEX_BASE] + (excl >> 16);
        for (int j = 0; j < (int)nv; ++j) {
          int c0, c1;
          march_vertex_edge(code, j, &c0, &c1);
          out[j] = (unsigned short)march_t16(
              base[march_corner_offset(c0, MARCH_SPAN)],
              base[march_corner_offset(c1, MARCH_SPAN)]);
        }
      }
      excl += (occupied ? 1u : 0u) | (nv << 16);
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
    lib.host_tables.argtypes = [p, p, p]
    lib.host_t16.argtypes = [p, p, i64, p]
    lib.host_segment_rows.restype = i32
    lib.host_segment_rows.argtypes = [i32]
    lib.host_classify.restype = i32
    lib.host_classify.argtypes = [p, i32, i32, i32, i32, p, p]
    lib.host_scan.restype = i64
    lib.host_scan.argtypes = [p, i32, i32, p, i32, p, p]
    lib.host_emit.argtypes = [p, i32, i32, i32, i32, p, i32, i64, i64, p]
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def host_image(lib, field, region):
    """The three kernels run on the host as the wrapper runs them on the
    card: (image int32, totals by marching_cuda.TOTALS name, with the
    occupied-tile list and the tile records the scan read). Candidate
    tiles are counted above marching.TILED_ABOVE corners an axis."""
    field = np.ascontiguousarray(field, np.float32)
    b = field.shape[0]
    g = -(-(b - 1) // marching.TILE)
    nrows = g * g * -(-g // marching_cuda.ROW_TILES)
    assert lib.host_segment_rows(b) == nrows
    # poisoned: a record the classify pass leaves unwritten shows
    records = np.full((g ** 3, 2), 0xFFFFFFFF, np.uint32)
    rows = np.full((nrows, 4), 0xFFFFFFFF, np.uint32)
    assert lib.host_classify(_ptr(field), b, *region, _ptr(records),
                             _ptr(rows)) == g ** 3
    tile_list = np.empty((g ** 3, marching_cuda.LIST_WIDTH), np.int32)
    totals = np.empty(len(marching_cuda.TOTALS), np.int64)
    reads = lib.host_scan(_ptr(rows), nrows, b, _ptr(records),
                          int(b > marching.TILED_ABOVE), _ptr(tile_list),
                          _ptr(totals))
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
    has them."""
    with open(marching_cuda.TABLES_HEADER) as f:
        assert f.read() == marching_cuda.tables_header()
    assert host.host_num_edges() == tables.NUM_EDGES
    assert host.host_max_vertices() == tables.MAX_CELL_VERTICES
    edges = np.empty((tables.NUM_EDGES, 2), np.int32)
    counts = np.empty((256, 2), np.int32)
    verts = np.empty((256, tables.MAX_CELL_VERTICES), np.int32)
    host.host_tables(_ptr(edges), _ptr(counts), _ptr(verts))
    np.testing.assert_array_equal(edges, tables.EDGES)
    np.testing.assert_array_equal(counts, tables.COUNT_TABLE)
    np.testing.assert_array_equal(verts, tables.VERT_TABLE)


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
    flushed field (and differs from the unflushed one)."""
    field, region = field_case(case)
    want, cm = _jax_image(field, region)
    if case == "subnormal":
        unflushed, _ = host_image(host, field, region)
        assert not np.array_equal(unflushed, want)
        field = flush_subnormals(field)
    got, t = host_image(host, field, region)
    assert (t["cells"], t["vertices"], t["indices"], t["candidates"]) == (
        int(cm.num_cells), int(cm.num_vertices), int(cm.num_indices), 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["sphere", "region_edges", "noise", "wide"])
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
@pytest.mark.parametrize("b", [256, 512])
def test_kernels_bit_for_bit_on_card(cuda_device, b):
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
    assert cm.num_cells > 10_000
    assert (cm.num_tiles > 0) == (b > marching.TILED_ABOVE)
    assert img.shape == want.shape and torch.equal(img, want)


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
    """Two images on two streams of the card at the same time, each bit
    for bit its plain image."""
    fields = [card_field(256, cuda_device, seed=s) for s in (1, 2)]
    region = (255, 255, 255)
    want = [_plain_on_card(f, region)[0] for f in fields]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in fields]
    got = [None, None]
    marched = [None, None]
    for i, (f, s) in enumerate(zip(fields, streams)):
        s.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(s):
            marched[i] = marching_cuda.classify(f, region)
    for i, s in enumerate(streams):
        with torch.cuda.stream(s):
            got[i] = marching_cuda.emit(marched[i])
    for s in streams:
        s.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
