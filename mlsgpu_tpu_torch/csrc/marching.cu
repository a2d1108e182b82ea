// Codes-mode marching and the codes image of a block step as three
// kernels: classification (march_classify_kernel), the scan of the tiles'
// counts (march_scan_kernel) and the emission straight into the image
// (march_emit_kernel).
//
// They stand for two programs the JAX package compiles with XLA,
// mlsgpu_tpu/ops/marching.py::generate(emit="codes") (:302; the dense
// classification :119, the tiled one :202) and
// mlsgpu_tpu/ops/block.py::_pack_codes (:322), jitted at
// mlsgpu_tpu/ops/block.py:649-657. Their plain PyTorch versions are
// mlsgpu_tpu_torch/ops/marching.py::generate_codes and
// mlsgpu_tpu_torch/ops/block.py::pack_codes, whose image the kernels write
// bit for bit (marching.cuh holds the arithmetic they share with a host
// build). ops/mls_cuda.py builds this file with the other kernels into one
// library; ops/marching_cuda.py calls the C entry points below through
// ctypes, on PyTorch's current stream, without synchronising: the
// wrapper's one sync is the copy of the totals, between the scan and the
// emission, which sizes the image.
//
// The order is the JAX package's: the occupied cells tile by tile (8^3
// cells a tile, tiles t = (tz * g + ty) * g + tx with g = ceil((B-1)/8)),
// raster order (z, y, x) inside a tile. The image is CodesFormat's
// (ops/block.py): M flat cell ids (cz * nc + cy) * nc + cx as words, then
// the M case codes a byte each from byte 4M, then from byte 4(M +
// ceil(M/4)) one t16 halfword a vertex, vertex j of a cell at its vertex
// base + j, zeros in the pad bytes of the last code and t16 words.
//
// What bounds them on the H100, and what the design does about it: the
// work is a few integer and float operations a cell, so reading the field
// bounds classification (4 B^3 bytes, 64 MiB at 256^3) and the emission
// reads only the tiles with surface. The plain versions run dozens of
// launches and two host syncs (the compaction's nonzero and the counts'
// tolist) and build an int64 code volume of (B-1)^3 cells (133 MB at
// 256^3). The kernels keep every intermediate in shared memory and
// registers:
//   * march_classify_kernel: a CTA a row segment of 8 tiles along x stages
//     their corners in shared memory as one (9, 9, 65) block, read in
//     rows of 65 floats and all of a thread's loads in flight together
//     (corners at index >= B read as NaN, as classify_tiled's pad); then
//     each warp classifies rows of 32 cells along x, a tile's counts are
//     summed by eight lanes and the warps, and the CTA writes an 8-byte
//     record a tile (occupied cells, candidate flag, vertices, indices)
//     and a 16-byte record for the segment (the same summed, and its
//     tiles with an occupied cell). With one tile a CTA and one load in
//     flight a thread the kernel waited on load latency at 8x its bound;
//     what is left is mostly the per-cell tests (8 loads from shared
//     memory, 8 sign and 8 finite tests a cell) and the y and z halos,
//     read by two CTAs.
//   * march_scan_kernel: one CTA of 1024 threads, a contiguous range of
//     segments a thread: it sums their records, an exclusive CTA scan of
//     the occupied tiles, cells and vertices gives its bases, and for each
//     of its segments with an occupied tile it reads the tiles' records
//     and writes a row (tile, cell base, vertex base) for each tile with
//     an occupied cell; then the totals (cells, vertices, indices,
//     candidate tiles, occupied tiles), which the host copies back in
//     one copy.
//   * march_emit_kernel: a CTA a row of that list restages the tile's
//     corners, recomputes its cells, ranks them in raster order with a
//     CTA scan of (occupied, vertices) and writes each cell's id word, code
//     byte and t16 halfwords at their final places. A code word or a t16
//     word can hold slots of two tiles, so codes and t16 are written as
//     bytes and halfwords, never as a read-modify-write of the word; no
//     atomics.

#include <cuda_runtime.h>

#include "marching.cuh"

namespace {

constexpr int CELL_THREADS = MARCH_TILE_CELLS;  // 512
constexpr int WARPS = CELL_THREADS / 32;
constexpr int ROW_TILES = MARCH_ROW_TILES;
constexpr int ROW_PITCH = MARCH_ROW_PITCH;
constexpr int ROW_CORNERS = MARCH_SPAN * MARCH_SPAN * ROW_PITCH;
constexpr int SCAN_THREADS = MARCH_SCAN_THREADS;
static_assert(2 * 32 == ROW_TILES * MARCH_TILE, "a warp pair spans a row");

// Copies the (9, 9, pitch) corners of the field from (x0, y0, z0) into
// `block`, NaN past the field's end (classify_tiled's pad). Each thread
// issues all of its loads before its first store to shared memory, so that
// they are in flight together.
template <int PITCH>
__device__ void stage(const float* __restrict__ field, int b, int x0, int y0,
                      int z0, float* block) {
  constexpr int CORNERS = MARCH_SPAN * MARCH_SPAN * PITCH;
  constexpr int PER = (CORNERS + CELL_THREADS - 1) / CELL_THREADS;
  float r[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = threadIdx.x + i * CELL_THREADS;
    const int x = x0 + k % PITCH, y = y0 + (k / PITCH) % MARCH_SPAN,
              z = z0 + k / (PITCH * MARCH_SPAN);
    r[i] = k < CORNERS && x < b && y < b && z < b
               ? __ldg(&field[((long long)z * b + y) * b + x])
               : __int_as_float(0x7fc00000);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = threadIdx.x + i * CELL_THREADS;
    if (k < CORNERS) block[k] = r[i];
  }
}

// A CTA a row segment: the tiles tx in [s * 8, s * 8 + 8) of row (ty, tz).
// Its block is staged once (rows of 65 corners along x, read coalesced);
// then each warp takes rows of 32 cells along x (a warp pair a row of the
// segment), eight rows a thread, so a thread's cells all lie in one tile
// and a warp reads shared memory without bank conflicts. Eight lanes sum a
// tile's counts, the warps' sums meet in shared memory, and the CTA writes
// a record a tile and one for the segment.
__global__ void __launch_bounds__(CELL_THREADS)
march_classify_kernel(const float* __restrict__ field, int b, int g,
                      int segments, int rx, int ry, int rz,
                      uint2* __restrict__ records, uint4* __restrict__ rows) {
  __shared__ float block[ROW_CORNERS];
  __shared__ uint2 part[WARPS][4];
  const int seg = blockIdx.x % segments, row = blockIdx.x / segments;
  const int ty = row % g, tz = row / g, tx0 = seg * ROW_TILES;
  const int n = min(ROW_TILES, g - tx0);
  stage<ROW_PITCH>(field, b, tx0 * MARCH_TILE, ty * MARCH_TILE,
                   tz * MARCH_TILE, block);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lx = (warp & 1) * 32 + lane;  // the cell's x in the segment
  unsigned cells = 0, counts = 0;
#pragma unroll 2
  for (int i = 0; i < MARCH_TILE; ++i) {
    const int q = (warp >> 1) + (WARPS / 2) * i;  // its (y, z) row
    const int ly = q % MARCH_TILE, lz = q / MARCH_TILE;
    float c[8];
    march_cell_corners(block + march_corner_index(lx, ly, lz, ROW_PITCH),
                       ROW_PITCH, c);
    const unsigned code = march_code(c);
    const bool occupied = march_occupied(
        c, code, tx0 * MARCH_TILE + lx < rx && ty * MARCH_TILE + ly < ry &&
                     tz * MARCH_TILE + lz < rz);
    // the tile's own corners are its cells' base corners
    cells += (occupied ? 1u : 0u) | (isfinite(c[0]) ? 1u << 16 : 0u);
    if (occupied)
      counts += march_vertex_count(code) | (march_index_count(code) << 16);
  }
#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
    cells += __shfl_xor_sync(0xFFFFFFFFu, cells, d);
    counts += __shfl_xor_sync(0xFFFFFFFFu, counts, d);
  }
  if ((lane & 7) == 0) part[warp][lane >> 3] = make_uint2(cells, counts);
  __syncthreads();
  if (warp == 0) {
    // lane j < n: tile tx0 + j, whose cells the warps of parity j / 4 hold
    unsigned tc = 0, tn = 0;
    if (lane < n) {
      for (int w = lane >> 2; w < WARPS; w += 2) {
        tc += part[w][lane & 3].x;
        tn += part[w][lane & 3].y;
      }
      const unsigned candidate = march_tile_candidate(tc) ? 1u << 16 : 0u;
      tc = march_tile_cells(tc) | candidate;
      records[(long long)row * g + tx0 + lane] = make_uint2(tc, tn);
    }
    unsigned sum[4] = {(march_tile_cells(tc) > 0 ? 1u : 0u) |
                           (march_tile_candidate(tc) ? 1u << 16 : 0u),
                       march_tile_cells(tc), march_tile_vertices(tn),
                       march_tile_indices(tn)};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int d = 1; d < 8; d <<= 1)
        sum[k] += __shfl_xor_sync(0xFFFFFFFFu, sum[k], d);
    if (lane == 0) rows[blockIdx.x] = make_uint4(sum[0], sum[1], sum[2], sum[3]);
  }
}

// An exclusive scan of three counts across the CTA's threads: `excl` gets
// this thread's prefix, `total` the CTA's sums. `shared` holds 3 ints a
// warp and 3 more.
__device__ void cta_scan3(const unsigned v[3], unsigned excl[3],
                          unsigned total[3], unsigned* shared) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  unsigned inc[3] = {v[0], v[1], v[2]};
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const unsigned o = __shfl_up_sync(0xFFFFFFFFu, inc[k], d);
      if (lane >= d) inc[k] += o;
    }
  }
  if (lane == 31)
    for (int k = 0; k < 3; ++k) shared[3 * warp + k] = inc[k];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const unsigned w = lane < warps ? shared[3 * lane + k] : 0u;
      unsigned s = w;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned o = __shfl_up_sync(0xFFFFFFFFu, s, d);
        if (lane >= d) s += o;
      }
      if (lane < warps) shared[3 * lane + k] = s - w;  // exclusive
      if (lane == warps - 1) shared[3 * 32 + k] = s;     // the CTA's total
    }
  }
  __syncthreads();
  for (int k = 0; k < 3; ++k) {
    excl[k] = shared[3 * warp + k] + inc[k] - v[k];
    total[k] = shared[3 * 32 + k];
  }
}

// One CTA: thread i takes the contiguous segments [i * per, (i + 1) *
// per), per = ceil(segments / SCAN_THREADS). Pass one sums its segment
// records, a CTA scan gives its bases, pass two walks its segments with an
// occupied tile again and writes the list rows of their occupied tiles
// from the tiles' records. Cells and tiles total below 2^32 (b <= 1024);
// the vertex and index totals are summed in 64 bits, and the wrapper
// refuses a block whose vertices pass the int32 bases.
__global__ void __launch_bounds__(SCAN_THREADS)
march_scan_kernel(const uint4* __restrict__ rows, int nrows, int segments,
                  int g, const uint2* __restrict__ records,
                  int count_candidates, int4* __restrict__ list, long long* __restrict__ totals) {
  __shared__ unsigned shared[3 * 32 + 3];
  __shared__ unsigned long long reduce[SCAN_THREADS / 32][3];
  const int per = (nrows + SCAN_THREADS - 1) / SCAN_THREADS;
  const int first = min(nrows, (int)threadIdx.x * per);
  const int last = min(nrows, first + per);
  // occupied tiles, cells, vertices of this thread's segments
  unsigned v[3] = {0u, 0u, 0u};
  unsigned long long sums[3] = {0, 0, 0};  // vertices, indices, candidates
#pragma unroll 4
  for (int r = first; r < last; ++r) {
    const uint4 seg = __ldg(&rows[r]);
    v[0] += march_segment_tiles(seg.x);
    v[1] += seg.y;
    v[2] += seg.z;
    sums[0] += seg.z;
    sums[1] += seg.w;
    sums[2] += march_segment_candidates(seg.x);
  }
  unsigned at[3], total[3];
  cta_scan3(v, at, total, shared);
  for (int r = first; r < last; ++r) {
    if (march_segment_tiles(__ldg(&rows[r]).x) == 0u) continue;
    const int t0 = (r / segments) * g + (r % segments) * ROW_TILES;
    const int n = min(ROW_TILES, g - (r % segments) * ROW_TILES);
    for (int j = 0; j < n; ++j) {
      const uint2 rec = __ldg(&records[t0 + j]);
      const unsigned cells = march_tile_cells(rec.x);
      if (cells == 0u) continue;
      list[at[0]] = make_int4(t0 + j, (int)at[1], (int)at[2], 0);
      at[0] += 1u;
      at[1] += cells;
      at[2] += march_tile_vertices(rec.y);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      sums[k] += __shfl_down_sync(0xFFFFFFFFu, sums[k], d);
    if (lane == 0) reduce[warp][k] = sums[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum[3] = {0, 0, 0};
    for (int w = 0; w < SCAN_THREADS / 32; ++w)
      for (int k = 0; k < 3; ++k) sum[k] += reduce[w][k];
    totals[MARCH_TOTAL_CELLS] = total[1];
    totals[MARCH_TOTAL_VERTICES] = (long long)sum[0];
    totals[MARCH_TOTAL_INDICES] = (long long)sum[1];
    totals[MARCH_TOTAL_CANDIDATES] = count_candidates ? (long long)sum[2] : 0;
    totals[MARCH_TOTAL_TILES] = total[0];
  }
}

// The exclusive scan of v across the CTA's CELL_THREADS threads, in thread
// order; `shared` holds an int a warp. The emission scans (occupied |
// vertices << 16), each sum over a tile below 2^16.
__device__ unsigned cta_exclusive_scan(unsigned v, unsigned* shared) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) shared[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = lane < WARPS ? shared[lane] : 0u;
    unsigned s = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned o = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += o;
    }
    if (lane < WARPS) shared[lane] = s - w;
  }
  __syncthreads();
  return shared[warp] + inc - v;
}

// A CTA a listed tile, a thread a cell l = (lz * 8 + ly) * 8 + lx: raster
// order is thread order, so the CTA's scan ranks the occupied cells.
__global__ void __launch_bounds__(CELL_THREADS)
march_emit_kernel(const float* __restrict__ field, int b, int g, int rx,
                  int ry, int rz, const int4* __restrict__ list,
                  long long m, long long vertices, int* __restrict__ image) {
  __shared__ float block[MARCH_TILE_CORNERS];
  __shared__ unsigned warp_sums[WARPS];
  const int4 row = __ldg(&list[blockIdx.x]);
  const int t = row.x;
  const int tx = t % g, ty = (t / g) % g, tz = t / (g * g);
  unsigned char* code_bytes = reinterpret_cast<unsigned char*>(image) + 4 * m;
  unsigned short* t16 = reinterpret_cast<unsigned short*>(image) +
                        2 * (m + (m + 3) / 4);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    // the pad bytes of the last code word and the pad halfword of the
    // last t16 word, zero as in the plain image
    for (long long p = m; p < 4 * ((m + 3) / 4); ++p) code_bytes[p] = 0;
    if (vertices & 1) t16[vertices] = 0;
  }
  stage<MARCH_SPAN>(field, b, tx * MARCH_TILE, ty * MARCH_TILE,
                    tz * MARCH_TILE, block);
  __syncthreads();
  const int l = threadIdx.x;
  const int lx = l % MARCH_TILE, ly = (l / MARCH_TILE) % MARCH_TILE,
            lz = l / (MARCH_TILE * MARCH_TILE);
  const float* base = block + march_corner_index(lx, ly, lz, MARCH_SPAN);
  float c[8];
  march_cell_corners(base, MARCH_SPAN, c);
  const unsigned code = march_code(c);
  const int cx = tx * MARCH_TILE + lx, cy = ty * MARCH_TILE + ly,
            cz = tz * MARCH_TILE + lz;
  const bool occupied = march_occupied(c, code, cx < rx && cy < ry && cz < rz);
  const unsigned nv = occupied ? march_vertex_count(code) : 0u;
  const unsigned excl =
      cta_exclusive_scan((occupied ? 1u : 0u) | (nv << 16), warp_sums);
  if (!occupied) return;
  const long long at = (long long)row.y + (excl & 0xFFFFu);
  const int nc = b - 1;
  image[at] = (cz * nc + cy) * nc + cx;
  code_bytes[at] = (unsigned char)code;
  unsigned short* out = t16 + (unsigned)row.z + (excl >> 16);
  // the edge's corners from shared memory (an index into c would put the
  // array in local memory)
  for (int j = 0; j < (int)nv; ++j) {
    int c0, c1;
    march_vertex_edge(code, j, &c0, &c1);
    out[j] = (unsigned short)march_t16(base[march_corner_offset(c0, MARCH_SPAN)],
                                       base[march_corner_offset(c1, MARCH_SPAN)]);
  }
}

int tiles_an_axis(int b) { return (b - 1 + MARCH_TILE - 1) / MARCH_TILE; }

bool bad_block(int b, int rx, int ry, int rz) {
  return b < 2 || b > 1024 || rx < 0 || ry < 0 || rz < 0 || rx > b - 1 ||
         ry > b - 1 || rz > b - 1;
}

}  // namespace

// march_classify_launch: for a (b, b, b) f32 field [z, y, x] (2 <= b <=
// 1024) and a region of (rx, ry, rz) cells, two kernels back to back on
// the stream: the classify pass into `records` (g^3 uint2, g =
// ceil((b-1)/8): a record a tile) and `rows` (g^2 * ceil(g/8) uint4: a
// record a row segment), then the scan into `list` (up to g^3 rows of 4
// ints: tile, cell base, vertex base, 0, for each tile with an occupied
// cell, in tile order) and `totals` (MARCH_TOTALS int64: cells, vertices,
// indices, candidate tiles when count_candidates else 0, tiles with an
// occupied cell). Returns the cudaError_t of the launches.
extern "C" int march_classify_launch(const float* field, int b, int rx,
                                     int ry, int rz, int count_candidates,
                                     unsigned* records, unsigned* rows,
                                     int* list, long long* totals,
                                     void* stream) {
  if (bad_block(b, rx, ry, rz)) return (int)cudaErrorInvalidValue;
  const int g = tiles_an_axis(b);
  const int segments = (g + ROW_TILES - 1) / ROW_TILES;
  const int nrows = g * g * segments;
  const cudaStream_t s = (cudaStream_t)stream;
  march_classify_kernel<<<nrows, CELL_THREADS, 0, s>>>(
      field, b, g, segments, rx, ry, rz, reinterpret_cast<uint2*>(records),
      reinterpret_cast<uint4*>(rows));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  march_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(
      reinterpret_cast<const uint4*>(rows), nrows, segments, g,
      reinterpret_cast<const uint2*>(records), count_candidates,
      reinterpret_cast<int4*>(list), totals);
  return (int)cudaGetLastError();
}

// march_emit_launch: the codes image of the block from the scan's list of
// `march_tiles` rows, m cells and `vertices` vertices (the totals), into
// `image` of m + ceil(m/4) + ceil(vertices/2) int32 words. No rows
// launch nothing.
extern "C" int march_emit_launch(const float* field, int b, int rx, int ry,
                                 int rz, const int* list, int march_tiles,
                                 long long m, long long vertices, int* image,
                                 void* stream) {
  if (bad_block(b, rx, ry, rz) || march_tiles < 0 || m < 0 || vertices < 0)
    return (int)cudaErrorInvalidValue;
  if (march_tiles == 0) return (int)cudaSuccess;
  march_emit_kernel<<<march_tiles, CELL_THREADS, 0, (cudaStream_t)stream>>>(
      field, b, tiles_an_axis(b), rx, ry, rz,
      reinterpret_cast<const int4*>(list), m, vertices, image);
  return (int)cudaGetLastError();
}
