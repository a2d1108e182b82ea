// Codes-mode marching and the codes image of a block step as three
// kernels: classification (march_classify_kernel), the scan of the tiles'
// counts (march_scan_kernel) and the emission straight into the image
// (march_emit_kernel); and for the packed and raw readbacks the mesh
// emission (march_emit_mesh_kernel) after the same classify and scan.
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
// reads only the tiles with surface. A cell needs of its corners only two
// bits each, the sign (>= 0) and whether it is finite, so both kernels
// compute those once a corner and then work on words of 32 cells at once:
// which cells are occupied is a dozen bitwise operations on their corner
// words (marching.cuh), and only the occupied cells (0.7% at 256^3) take
// a code, a table lookup and their vertices.
//   * march_classify_kernel: a warp a column of 8 tiles along x, 2 along y
//     and a run along z (march_run_tiles), which it walks a corner plane
//     at a time, each warp on its own (no CTA barrier): a ring of two
//     planes of (17 rows, 2 halves of 33 corners) in shared memory, filled
//     by cp.async copies of 16 bytes where a row starts 16-byte aligned and
//     of 4 elsewhere (any b; NaN written past the field's end,
//     classify_tiled's pad), keeps the next plane in flight while one is
//     classified. Lane (y, h) turns its row half into a sign and a finite
//     word (16-byte shared loads); its next row comes from the next lane
//     (the band's last row by ballot), the plane below from its registers,
//     so each plane is read once in a run. The occupied word of its 32
//     cells, their counts by tile as popcounts, the vertex and index counts
//     of the occupied cells from the table in shared memory. At the end of
//     a tile layer eight lanes sum each tile's counts and write an 8-byte
//     record a tile (occupied cells, candidate flag, vertices, indices)
//     and a 16-byte record a row segment (the same summed, and its tiles
//     with an occupied cell).
//   * march_scan_kernel: a row segment a thread, 256 segments a CTA, on
//     the single-launch look-back scan of scan.cuh: each CTA takes its
//     tile of segments by ticket, sums their records (a CTA scan of the
//     cells, vertices, indices, candidate and occupied tiles), publishes
//     the tile's sums and looks back over lower tickets for its bases; each
//     thread then reads its segment's tile records (if it has an occupied
//     tile) and writes a row (tile, cell base, vertex base) for each tile
//     with an occupied cell, and the last tile by ticket writes the totals
//     (cells, vertices, indices, candidate tiles, occupied tiles), which
//     the host copies back in one copy. The classify pass clears the
//     scan's ticket and status words, so the stage stays at three
//     launches. 16 CTAs at 256^3, 128 at 512^3 (one CTA of 1024 threads
//     before, on one SM).
//   * march_emit_kernel: a warp a row of that list (8 tiles a CTA, all
//     their corners in flight at once): it stages the tile's 9^3 corners
//     by cp.async, a lane a corner row makes the row's sign and finite
//     bits, 16 lanes the occupied words of the tile's 512 cells in raster
//     order, a warp scan of their popcounts ranks them, and the occupied
//     cells go into a list in shared memory. Then 32 occupied cells at a
//     time, a lane each: a warp scan of their vertex counts, each cell's
//     id word and code byte written, its vertices marked as its own in an
//     owner map (march_spread_vertices), and the vertices a lane each, so
//     that each lane computes one t16 and a warp's halfword stores are
//     contiguous. The tables (vertex counts, the END_OFFSETS table of each
//     vertex's edge corners) are copied into shared memory once a CTA. A
//     code word or a t16 word can hold slots of two tiles, so codes and
//     t16 are written as bytes and halfwords, never as a read-modify-write
//     of the word; no atomics.
//   * march_emit_mesh_kernel (generate(emit="mesh"), :302; plain
//     mlsgpu_tpu_torch/ops/marching.py::generate_mesh): it writes ~24
//     bytes a vertex (3 floats, two key halves, a 4-byte compact key at 28
//     and 31 key bits; 8 bytes above 32) and 4 an index, so those writes
//     bound it; but on the H100 a warp a tile, its first design, spent 16
//     us a tile at 256^3 on a chain of staging (6 us: 27 four-byte copies
//     a lane, then the wait), ranking and two loops over ~400 vertices and
//     ~300 triangles 32 at a time, one wave of ~14 warps an SM waiting on
//     it. So a CTA of 128
//     threads takes a listed tile (1,894 CTAs at 256^3, 8,887 at 512^3):
//     threads 0-80 stage a corner row each at a pitch of 12 floats, as two
//     16-byte cp.async and one 4-byte copy where the row starts 16-byte
//     aligned (4-byte copies elsewhere, NaN past the field's end:
//     classify's rule), and make its sign and finite bits as soon as their
//     own copies land; after one barrier thread t takes the occupancy and
//     codes of the cells 4t .. 4t + 3 from four row words, and one CTA
//     scan of (cells, vertices | triangles << 16) ranks them and gives
//     every occupied cell its first vertex and triangle in the tile, kept
//     in a list in shared memory. Then 128 occupied cells at a time (a
//     batch: one for the median tile of the bench cloud, four for a tile
//     of 512 cells) a thread a cell marks its vertices and triangles in
//     two owner maps sized for the batch's worst (1,664 and 1,536), and
//     the batch's vertices and triangles go a thread each, consecutive
//     threads to consecutive outputs: a word a thread for the key halves
//     and keys, a 12-byte record a thread (three stores) for positions and
//     triangles. Staging those records in shared memory to store them as
//     16-byte vectors measured slower (0.0230-0.0237 ms against 0.0182 at
//     256^3), as did copying the tables to shared memory a CTA (0.0269);
//     the tables (VERT_CORNERS, INDEX_TABLE, COUNT_TABLE) are read through
//     the read-only cache. 11.5 KB of shared memory and 40 registers a
//     thread: 12 CTAs (48 warps) an SM; capping registers at 32 for 16
//     CTAs measured slower (0.0193 ms).

#include <cuda_runtime.h>

#include "marching.cuh"
#include "mesh.cuh"
#include "scan.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int ROW_TILES = MARCH_ROW_TILES;
constexpr int SCAN_THREADS = MARCH_SCAN_THREADS;
// classify: a warp a column, CLASSIFY_WARPS columns a CTA. A stage of the
// ring is a corner plane of the column: (BAND_ROWS + 1) rows of two halves
// of 33 corners (x, x + 1, ..., x + 32), each at a pitch of 36 floats.
constexpr int CLASSIFY_WARPS = 2;
constexpr int CLASSIFY_THREADS = 32 * CLASSIFY_WARPS;
constexpr int BAND_ROWS = MARCH_BAND_TILES * MARCH_TILE;  // 16
constexpr int STAGE_ROWS = BAND_ROWS + 1;
constexpr int STAGE_PITCH = 36;
constexpr int STAGE_HALF = STAGE_ROWS * STAGE_PITCH;
constexpr int STAGE = 2 * STAGE_HALF;
constexpr int STAGES = 2;
static_assert(2 * 32 == ROW_TILES * MARCH_TILE, "two words span a segment");
static_assert(2 * BAND_ROWS == 32, "a lane a row half of the band");
// emit: a warp a listed tile
constexpr int EMIT_WARPS = 8;
constexpr int EMIT_THREADS = 32 * EMIT_WARPS;
constexpr int TILE_ROWS = MARCH_SPAN * MARCH_SPAN;  // a tile's corner rows
constexpr int CELL_WORDS = MARCH_TILE_CELLS / 32;   // a tile's cell words
constexpr int ENDS = 256 * MARCH_MAX_CELL_VERTICES;
constexpr int BATCH_VERTICES = 32 * MARCH_MAX_CELL_VERTICES;
static_assert(EMIT_THREADS == 256, "a thread a code fills the table");
// emit mesh: a CTA a listed tile (mesh.cuh): its staged corners, a batch
// of occupied cells a thread each, their vertices' and triangles' owner
// maps
constexpr int MESH_THREADS = MESH_EMIT_THREADS;
constexpr int MESH_WARPS = MESH_THREADS / 32;
constexpr int STAGED = MESH_STAGE_ROWS * MESH_STAGE_PITCH;
constexpr int MESH_BATCH_VERTICES = MESH_THREADS * MARCH_MAX_CELL_VERTICES;
constexpr int MESH_BATCH_TRIANGLES =
    MESH_THREADS * MARCH_MAX_CELL_INDICES / 3;
static_assert(MESH_THREADS * MESH_EMIT_CELLS == MARCH_TILE_CELLS,
              "a thread 4 cells of the tile");
static_assert(MESH_THREADS <= 256 && MESH_STAGE_ROWS <= MESH_THREADS,
              "a batch's cell fits an owner byte; a thread a corner row");
static_assert(ENDS % 2 == 0, "the END_OFFSETS table copies as words");

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The sign and finite bits of four corners at bits x .. x + 3.
__device__ __forceinline__ void corner_bits4(float4 v, int x, unsigned& s,
                                             unsigned& f) {
  s |= (march_sign_bit(v.x) << x) | (march_sign_bit(v.y) << (x + 1)) |
       (march_sign_bit(v.z) << (x + 2)) | (march_sign_bit(v.w) << (x + 3));
  f |= (march_finite_bit(v.x) << x) | (march_finite_bit(v.y) << (x + 1)) |
       (march_finite_bit(v.z) << (x + 2)) | (march_finite_bit(v.w) << (x + 3));
}

// Warp `task` = (run * bands + band) * segments + seg: the tiles tx in [8 seg,
// 8 seg + 8), ty in [2 band, 2 band + 2), tz in [run_tiles * run, ...)
// (fewer at the field's end). Corner plane q of the run is z0 + q; cell
// plane q - 1 lies between planes q - 1 and q, so a layer of tiles ends at
// every eighth plane and the last plane of a run is the next run's first
// too. Lane (y, h) = (lane % 16, lane / 16) takes the corner row y0 + y,
// corners x0 + 32 h .. x0 + 32 h + 31: the 32 cells with those base
// corners.
__global__ void __launch_bounds__(CLASSIFY_THREADS)
march_classify_kernel(const float* __restrict__ field, int b, int g,
                      int run_tiles, int rx, int ry, int rz,
                      uint2* __restrict__ records, uint4* __restrict__ rows,
                      unsigned long long* __restrict__ scan_state,
                      long long scan_words) {
  __shared__ __align__(16) float ring[CLASSIFY_WARPS][STAGES][STAGE];
  __shared__ unsigned counts[256];
  // the scan's ticket and status words, zero before it starts (scan.cuh)
  for (long long i = blockIdx.x * (long long)CLASSIFY_THREADS + threadIdx.x;
       i < scan_words; i += (long long)gridDim.x * CLASSIFY_THREADS)
    scan_state[i] = 0ULL;
  for (int i = threadIdx.x; i < 256; i += CLASSIFY_THREADS)
    counts[i] = march_cell_counts(i);
  __syncthreads();
  const int segments = march_segments(g), bands = march_bands(g);
  const int runs = (g + run_tiles - 1) / run_tiles;
  const int task = blockIdx.x * CLASSIFY_WARPS + (threadIdx.x >> 5);
  if (task >= segments * bands * runs) return;
  const int seg = task % segments, band = task / segments % bands,
            run = task / (segments * bands);
  const int ty0 = band * MARCH_BAND_TILES, tz0 = run * run_tiles;
  const int n = min(ROW_TILES, g - seg * ROW_TILES);
  const int layers = min(run_tiles, g - tz0);
  const int planes = layers * MARCH_TILE + 1;
  const int x0 = seg * ROW_TILES * MARCH_TILE, y0 = ty0 * MARCH_TILE,
            z0 = tz0 * MARCH_TILE;
  const int lane = threadIdx.x & 31;
  float* const stages = ring[threadIdx.x >> 5][0];

  // plane q into its stage, a commit group (empty past the run); NaN past
  // the field's end
  auto issue = [&](int q) {
    if (q < planes) {
      const int z = z0 + q;
      float* const stage = stages + (q % STAGES) * STAGE;
      if (z < b) {
        // lane (c, r0) = (lane % 8, lane / 8): corners x + 4c .. x + 4c + 3
        // of both row halves of the rows r0, r0 + 4, ...: 16 bytes where
        // the row's start allows it, else 4 at a time
        const int c4 = 4 * (lane % 8), r0 = lane / 8;
        const float* src = field + ((long long)z * b + y0 + r0) * b + x0 + c4;
        float* dst = stage + r0 * STAGE_PITCH + c4;
        for (int r = r0; r < STAGE_ROWS;
             r += 4, src += 4 * (long long)b, dst += 4 * STAGE_PITCH) {
          const bool whole = y0 + r < b &&
                             (reinterpret_cast<size_t>(src) & 15u) == 0u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = x0 + 32 * h + c4;
            if (whole && x + 3 < b) {
              cp_async16(dst + h * STAGE_HALF, src + 32 * h);
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                if (y0 + r < b && x + k < b)
                  cp_async4(dst + h * STAGE_HALF + k, src + 32 * h + k);
                else
                  dst[h * STAGE_HALF + k] = nan_f();
              }
            }
          }
        }
        // corner 32 of the row halves hr = lane and lane + 32
        for (int hr = lane; hr < 2 * STAGE_ROWS; hr += 32) {
          const int h = hr / STAGE_ROWS, r = hr % STAGE_ROWS;
          const int x = x0 + 32 * h + 32, y = y0 + r;
          float* to = stage + h * STAGE_HALF + r * STAGE_PITCH + 32;
          if (y < b && x < b)
            cp_async4(to, field + ((long long)z * b + y) * b + x);
          else
            *to = nan_f();
        }
      } else {
        for (int i = lane; i < STAGE; i += 32) stage[i] = nan_f();
      }
    }
    cp_async_commit();
  };
  for (int q = 0; q < STAGES - 1; ++q) issue(q);

  const int y = lane % BAND_ROWS, h = lane / BAND_ROWS;
  const int left = rx - (x0 + 32 * h);  // cells of the region in the word
  const unsigned region_x =
      left >= 32 ? FULL : left <= 0 ? 0u : (1u << left) - 1u;
  const bool row_in = y0 + y < ry;
  // the corner words dx + 2 dy of this lane's cells in the plane below
  unsigned below_s[4] = {0u, 0u, 0u, 0u}, below_f[4] = {0u, 0u, 0u, 0u};
  // this layer's: own finite corners (row y), occupied cells of tile j in
  // byte j, vertices | indices << 16 of tile j
  unsigned own = 0u, cells = 0u, sums[4] = {0u, 0u, 0u, 0u};
  for (int q = 0; q < planes; ++q) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();  // plane q is in; every lane is done with plane q - 1
    issue(q + STAGES - 1);
    const float* st = stages + (q % STAGES) * STAGE;
    // this lane's row half and its next corner
    const float* mine = st + h * STAGE_HALF + y * STAGE_PITCH;
    unsigned s = 0u, f = 0u;
#pragma unroll
    for (int x = 0; x < 32; x += 4)
      corner_bits4(*reinterpret_cast<const float4*>(mine + x), x, s, f);
    const unsigned next = march_sign_bit(mine[32]) |
                          (march_finite_bit(mine[32]) << 1);
    // the band's last row (y = 16), by ballot, for lanes y = 15
    const float* last = st + BAND_ROWS * STAGE_PITCH;
    const float l0 = last[lane], l1 = last[STAGE_HALF + lane];
    const float lt = lane < 2 ? last[lane * STAGE_HALF + 32] : 0.0f;
    const unsigned last_s[2] = {__ballot_sync(FULL, march_sign_bit(l0)),
                                __ballot_sync(FULL, march_sign_bit(l1))};
    const unsigned last_f[2] = {__ballot_sync(FULL, march_finite_bit(l0)),
                                __ballot_sync(FULL, march_finite_bit(l1))};
    const unsigned last_ts = __ballot_sync(FULL, lane < 2 && march_sign_bit(lt));
    const unsigned last_tf =
        __ballot_sync(FULL, lane < 2 && march_finite_bit(lt));
    // row y + 1: the next lane's
    unsigned s1 = __shfl_down_sync(FULL, s, 1);
    unsigned f1 = __shfl_down_sync(FULL, f, 1);
    unsigned next1 = __shfl_down_sync(FULL, next, 1);
    if (y == BAND_ROWS - 1) {
      s1 = last_s[h];
      f1 = last_f[h];
      next1 = ((last_ts >> h) & 1u) | (((last_tf >> h) & 1u) << 1);
    }
    const unsigned now_s[4] = {s, march_next_corners(s, next), s1,
                               march_next_corners(s1, next1)};
    const unsigned now_f[4] = {f, march_next_corners(f, next >> 1), f1,
                               march_next_corners(f1, next1 >> 1)};
    if (q > 0) {
      const unsigned sign[8] = {below_s[0], below_s[1], below_s[2],
                                below_s[3], now_s[0],   now_s[1],
                                now_s[2],   now_s[3]};
      const unsigned fin[8] = {below_f[0], below_f[1], below_f[2],
                               below_f[3], now_f[0],   now_f[1],
                               now_f[2],   now_f[3]};
      const unsigned occ = march_word_occupied(
          sign, fin, row_in && z0 + q - 1 < rz ? region_x : 0u);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cells += (unsigned)__popc(occ & (0xFFu << (8 * j))) << (8 * j);
      for (unsigned o = occ; o != 0u; o &= o - 1u) {
        const int x = __ffs(o) - 1;
        const unsigned c = counts[march_word_code(sign, x)];
        const int j = x / MARCH_TILE;
        sums[0] += j == 0 ? c : 0u;
        sums[1] += j == 1 ? c : 0u;
        sums[2] += j == 2 ? c : 0u;
        sums[3] += j == 3 ? c : 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      below_s[i] = now_s[i];
      below_f[i] = now_f[i];
    }
    if (q > 0 && q % MARCH_TILE == 0) {
      // cell plane q - 1 ended layer k: each tile's sums over its eight
      // lanes (same h, rows y / 8), written by the first of them
      const int k = q / MARCH_TILE - 1, t = y / MARCH_TILE;
      unsigned lo = (cells & 0xFFu) | ((cells & 0xFF00u) << 8);
      unsigned hi = ((cells >> 16) & 0xFFu) | ((cells >> 8) & 0xFF0000u);
#pragma unroll
      for (int d = 1; d < MARCH_TILE; d <<= 1) {
        lo += __shfl_xor_sync(FULL, lo, d);
        hi += __shfl_xor_sync(FULL, hi, d);
        own |= __shfl_xor_sync(FULL, own, d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sums[j] += __shfl_xor_sync(FULL, sums[j], d);
      }
      const unsigned tile_cells[4] = {lo & 0xFFFFu, lo >> 16, hi & 0xFFFFu,
                                      hi >> 16};
      unsigned seg_sum[4] = {0u, 0u, 0u, 0u};
      const long long row = (long long)(tz0 + k) * g + ty0 + t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool candidate = ((own >> (8 * j)) & 0xFFu) != 0u;
        const unsigned x = tile_cells[j] | (candidate ? 1u << 16 : 0u);
        const int tx = 4 * h + j;
        if (y % MARCH_TILE == 0 && tx < n && ty0 + t < g)
          records[row * g + seg * ROW_TILES + tx] = make_uint2(x, sums[j]);
        if (tx < n) {
          seg_sum[0] += (tile_cells[j] > 0 ? 1u : 0u) |
                        (candidate ? 1u << 16 : 0u);
          seg_sum[1] += tile_cells[j];
          seg_sum[2] += march_tile_vertices(sums[j]);
          seg_sum[3] += march_tile_indices(sums[j]);
        }
      }
      // the segment's two halves (lanes h = 0 and 1 of the same row)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        seg_sum[i] += __shfl_xor_sync(FULL, seg_sum[i], BAND_ROWS);
      if (lane % BAND_ROWS == t * MARCH_TILE && h == 0 && ty0 + t < g)
        rows[row * march_segments(g) + seg] =
            make_uint4(seg_sum[0], seg_sum[1], seg_sum[2], seg_sum[3]);
      own = cells = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) sums[j] = 0u;
    }
    // plane q is one of layer q / 8's own (all but the run's last plane)
    if (q < planes - 1) own |= f;
  }
}

// A row segment a thread, SCAN_THREADS segments a tile, the tile by
// ticket (scan.cuh). The thread's counts (cells, vertices, indices,
// candidate tiles, tiles with an occupied cell: the totals' order), a CTA
// scan of them, then a lane a count publishes the tile's aggregate and
// looks back for its exclusive prefix; each thread then writes the list
// rows of its segment's occupied tiles from the tiles' records (the eight
// loads in flight together), and the last tile, once it has its inclusive
// prefixes, the totals. A tile's sums stay below 2^32 (256 segments of 8
// tiles); the prefixes and totals are 64-bit, and the wrappers refuse a
// block whose vertices (or, for the mesh readbacks, indices) pass the
// int32 bases.
__global__ void __launch_bounds__(SCAN_THREADS)
march_scan_kernel(const uint4* __restrict__ rows, int nrows, int segments,
                  int g, const uint2* __restrict__ records,
                  int count_candidates, unsigned long long* state,
                  int4* __restrict__ list, long long* __restrict__ totals) {
  __shared__ unsigned shared[MARCH_TOTALS * 33];
  __shared__ unsigned long long base[MARCH_TOTALS];
  const int tile = scan_ticket(state);
  unsigned long long* const status = state + 1;
  const int r = tile * SCAN_THREADS + threadIdx.x;
  const uint4 seg = r < nrows ? __ldg(&rows[r]) : make_uint4(0u, 0u, 0u, 0u);
  const unsigned v[MARCH_TOTALS] = {seg.y, seg.z, seg.w,
                                    march_segment_candidates(seg.x),
                                    march_segment_tiles(seg.x)};
  unsigned at[MARCH_TOTALS], total[MARCH_TOTALS];
  scan_cta<MARCH_TOTALS>(v, at, total, shared);
  if (threadIdx.x < MARCH_TOTALS) {
    const int k = threadIdx.x;
    unsigned long long* word = status + (long long)tile * MARCH_TOTALS + k;
    unsigned long long excl = 0;
    if (tile == 0) {
      scan_publish(word, SCAN_INCLUSIVE, total[k]);
    } else {
      scan_publish(word, SCAN_AGGREGATE, total[k]);
      excl = scan_lookback(status + k, MARCH_TOTALS, tile);
      scan_publish(word, SCAN_INCLUSIVE, excl + total[k]);
    }
    base[k] = excl;
    if (tile == (int)gridDim.x - 1)
      totals[k] = k == MARCH_TOTAL_CANDIDATES && !count_candidates
                      ? 0
                      : (long long)(excl + total[k]);
  }
  __syncthreads();
  if (v[MARCH_TOTAL_TILES] == 0u) return;
  long long row_at = (long long)(base[MARCH_TOTAL_TILES] + at[MARCH_TOTAL_TILES]);
  unsigned long long cells = base[MARCH_TOTAL_CELLS] + at[MARCH_TOTAL_CELLS];
  unsigned long long vertices =
      base[MARCH_TOTAL_VERTICES] + at[MARCH_TOTAL_VERTICES];
  unsigned long long indices =
      base[MARCH_TOTAL_INDICES] + at[MARCH_TOTAL_INDICES];
  const int t0 = (r / segments) * g + (r % segments) * ROW_TILES;
  const int n = min(ROW_TILES, g - (r % segments) * ROW_TILES);
  uint2 rec[ROW_TILES];
#pragma unroll
  for (int j = 0; j < ROW_TILES; ++j)
    rec[j] = j < n ? __ldg(&records[t0 + j]) : make_uint2(0u, 0u);
#pragma unroll
  for (int j = 0; j < ROW_TILES; ++j) {
    const unsigned c = march_tile_cells(rec[j].x);
    if (c == 0u) continue;
    list[row_at] = make_int4(t0 + j, (int)cells, (int)vertices, (int)indices);
    row_at += 1;
    cells += c;
    vertices += march_tile_vertices(rec[j].y);
    indices += march_tile_indices(rec[j].y);
  }
}

// Stage list row r's tile for a warp of an emit kernel: its (9, 9, 9)
// corners into `block` by cp.async (NaN past the field's end), one commit
// group for every lane (empty past march_tiles). Returns the row; the
// tile's coordinates in tx, ty, tz.
__device__ __forceinline__ int4 emit_stage_tile(const float* __restrict__ field,
                                                int b, int g,
                                                const int4* __restrict__ list,
                                                int r, int march_tiles,
                                                int lane, float* block,
                                                int& tx, int& ty, int& tz) {
  int4 row = make_int4(0, 0, 0, 0);
  tx = ty = tz = 0;
  if (r < march_tiles) {
    row = __ldg(&list[r]);
    tx = row.x % g, ty = row.x / g % g, tz = row.x / (g * g);
    // lane (x, y3) < 27: corner x of the rows y = y3, y3 + 3, y3 + 6 of
    // each corner plane
    if (lane < 3 * MARCH_SPAN) {
      const int x = lane % MARCH_SPAN, y3 = lane / MARCH_SPAN;
      const int x0 = tx * MARCH_TILE, y0 = ty * MARCH_TILE,
                z0 = tz * MARCH_TILE;
      const float* src = field + ((long long)z0 * b + y0 + y3) * b + x0 + x;
      float* dst = block + y3 * MARCH_SPAN + x;
      for (int z = 0; z < MARCH_SPAN; ++z) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float* to = dst + (z * MARCH_SPAN + 3 * j) * MARCH_SPAN;
          if (x0 + x < b && y0 + y3 + 3 * j < b && z0 + z < b)
            cp_async4(to, src + ((long long)z * b + 3 * j) * b);
          else
            *to = nan_f();
        }
      }
    }
  }
  cp_async_commit();
  return row;
}

// A staged tile's occupied cells (a warp, after the corners landed): a
// lane a corner row (y, z) makes its sign bits 0-8 and finite bits 16-24
// in `bits`, lanes k < 16 cell word k's occupied cells, and a warp scan
// of their popcounts ranks them into `cell_l` in raster order. Returns the
// tile's occupied cells.
__device__ __forceinline__ unsigned emit_rank_cells(
    const float* block, unsigned* bits, unsigned short* cell_l, int lane,
    int rx, int ry, int rz, int tx, int ty, int tz) {
  for (int k = lane; k < TILE_ROWS; k += 32) {
    unsigned v = 0u;
#pragma unroll
    for (int x = 0; x < MARCH_SPAN; ++x) {
      const float c = block[k * MARCH_SPAN + x];
      v |= (march_sign_bit(c) << x) | (march_finite_bit(c) << (16 + x));
    }
    bits[k] = v;
  }
  __syncwarp();
  unsigned occ = 0u;
  if (lane < CELL_WORDS) {
    const int lz = lane / 2, ly0 = 4 * (lane % 2);
    unsigned sign[8], fin[8];
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        unsigned rows4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rows4[i] = bits[(lz + dz) * MARCH_SPAN + ly0 + dy + i];
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          sign[dx + 2 * dy + 4 * dz] = march_row_bytes(rows4, dx);
          fin[dx + 2 * dy + 4 * dz] = march_row_bytes(rows4, 16 + dx);
        }
      }
    // the region: cells lx < rx - 8 tx of the rows ly < ry - 8 ty, in
    // cell plane lz < rz - 8 tz
    const int nx = min(max(rx - tx * MARCH_TILE, 0), MARCH_TILE);
    const unsigned byte = (1u << nx) - 1u;
    unsigned region = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (ty * MARCH_TILE + ly0 + i < ry) region |= byte << (8 * i);
    if (tz * MARCH_TILE + lz >= rz) region = 0u;
    occ = march_word_occupied(sign, fin, region);
  }
  const unsigned n_occ = __popc(occ);
  unsigned at = n_occ;
#pragma unroll
  for (int d = 1; d < CELL_WORDS; d <<= 1) {
    const unsigned o = __shfl_up_sync(FULL, at, d);
    if (lane >= d) at += o;
  }
  const unsigned tile_cells = __shfl_sync(FULL, at, CELL_WORDS - 1);
  at -= n_occ;
  for (unsigned o = occ; o != 0u; o &= o - 1u)
    cell_l[at++] = (unsigned short)(32 * lane + __ffs(o) - 1);
  __syncwarp();
  return tile_cells;
}

// A warp a listed tile, 8 a CTA. Cell l = (lz * 8 + ly) * 8 + lx of the
// tile is bit l % 32 of its cell word l / 32 (raster order is word and bit
// order): word k holds the rows ly = 4 (k % 2) .. + 3 of cell plane k / 2,
// a byte a row.
__global__ void __launch_bounds__(EMIT_THREADS)
march_emit_kernel(const float* __restrict__ field, int b, int g, int rx,
                  int ry, int rz, const int4* __restrict__ list,
                  int march_tiles, long long m, long long vertices,
                  int* __restrict__ image) {
  __shared__ float blocks[EMIT_WARPS][MARCH_TILE_CORNERS];
  __shared__ unsigned row_bits[EMIT_WARPS][TILE_ROWS];
  // the tile's occupied cells in raster order
  __shared__ unsigned short occupied[EMIT_WARPS][MARCH_TILE_CELLS];
  __shared__ unsigned char owner[EMIT_WARPS][BATCH_VERTICES];
  __shared__ __align__(4) unsigned short end_offsets[ENDS];
  __shared__ unsigned char nverts[256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * EMIT_WARPS + warp;
  unsigned char* code_bytes = reinterpret_cast<unsigned char*>(image) + 4 * m;
  unsigned short* t16 = reinterpret_cast<unsigned short*>(image) +
                        2 * (m + (m + 3) / 4);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    // the pad bytes of the last code word and the pad halfword of the
    // last t16 word, zero as in the plain image
    for (long long p = m; p < 4 * ((m + 3) / 4); ++p) code_bytes[p] = 0;
    if (vertices & 1) t16[vertices] = 0;
  }
  float* block = blocks[warp];
  int tx, ty, tz;
  const int4 row = emit_stage_tile(field, b, g, list, r, march_tiles, lane,
                                   block, tx, ty, tz);
  for (int i = threadIdx.x; i < ENDS / 2; i += EMIT_THREADS)
    reinterpret_cast<unsigned*>(end_offsets)[i] = __ldg(
        reinterpret_cast<const unsigned*>(&march_end_offsets_d[0][0]) + i);
  nverts[threadIdx.x] = (unsigned char)march_vertex_count(threadIdx.x);
  cp_async_wait<0>();
  __syncthreads();
  if (r >= march_tiles) return;
  unsigned* bits = row_bits[warp];
  unsigned short* cell_l = occupied[warp];
  const unsigned tile_cells =
      emit_rank_cells(block, bits, cell_l, lane, rx, ry, rz, tx, ty, tz);
  // 32 occupied cells at a time, a lane each; then their vertices
  const int nc = b - 1;
  const long long cell_base = row.y;
  long long vertex_at = (unsigned)row.z;
  unsigned char* own = owner[warp];
  for (unsigned first = 0; first < tile_cells; first += 32) {
    const unsigned i = first + lane;
    const unsigned l = i < tile_cells ? cell_l[i] : 0u;
    const int lx = l % MARCH_TILE, ly = l / MARCH_TILE % MARCH_TILE,
              lz = l / (MARCH_TILE * MARCH_TILE);
    const int row0 = lz * MARCH_SPAN + ly, row1 = row0 + MARCH_SPAN;
    const unsigned code =
        i < tile_cells ? march_rows_code(bits[row0], bits[row0 + 1],
                                         bits[row1], bits[row1 + 1], lx)
                       : 0u;
    const unsigned nv = nverts[code];
    unsigned incl = nv;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned o = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += o;
    }
    if (i < tile_cells) {
      const int cx = tx * MARCH_TILE + lx, cy = ty * MARCH_TILE + ly,
                cz = tz * MARCH_TILE + lz;
      image[cell_base + i] = (cz * nc + cy) * nc + cx;
      code_bytes[cell_base + i] = (unsigned char)code;
    }
    march_spread_vertices(own, incl - nv, nv, lane);
    __syncwarp();
    const unsigned total = __shfl_sync(FULL, incl, 31);
    // what a vertex needs of its cell: the code, its first vertex (< 416)
    // and its base corner in the block (< 729), in one word
    const unsigned cell =
        code | ((incl - nv) << 8) |
        ((unsigned)march_corner_index(lx, ly, lz) << 17);
    // two vertices a lane at a time, their loads in flight together
    for (unsigned v0 = 0; v0 < total; v0 += 64) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const unsigned v = v0 + 32 * u + lane;
        const int o = v < total ? own[v] : 0;
        const unsigned o_cell = __shfl_sync(FULL, cell, o);
        const int o_base = (int)(o_cell >> 17);
        if (v < total) {
          const unsigned e = march_vertex_end_offsets(
              end_offsets, o_cell & 0xFFu,
              (int)(v - ((o_cell >> 8) & 0x1FFu)));
          t16[vertex_at + v] = (unsigned short)march_t16(
              block[o_base + (e & 0xFFu)], block[o_base + (e >> 8)]);
        }
      }
    }
    __syncwarp();  // the owner map is rewritten by the next batch
    vertex_at += total;
  }
}

// A CTA a listed tile. Threads 0-80 stage its 9^3 corners by cp.async, a
// corner row each at MESH_STAGE_PITCH floats (16-byte copies where the row
// starts aligned), and make the row's sign and finite bits once their own
// copies have landed; then thread t the occupancy and codes of the cells
// 4 t .. 4 t + 3 (raster order) and their vertex and triangle counts; one
// CTA scan of those gives every occupied cell its rank and its first
// vertex and triangle in the tile, and the occupied cells go into a list
// in shared memory. Then MESH_THREADS occupied cells at a time (a batch),
// a thread each marks its vertices and triangles as its own in two owner
// maps, and the batch's vertices and triangles are taken a thread each,
// consecutive threads to consecutive outputs: a vertex's position, key
// halves and compact sort key (SK: 4 bytes up to 32 key bits, else 8), a
// triangle's three int32 indices. Vertex j of a cell lands at the tile's
// vertex base + the cell's first vertex + j, as in generate_mesh's
// emission order; index i of a cell at the tile's index base + 3 x its
// first triangle + i. The tables are read through the read-only cache.
template <typename SK>
__global__ void __launch_bounds__(MESH_THREADS)
march_emit_mesh_kernel(const float* __restrict__ field, int b, int g, int rx,
                       int ry, int rz, const __grid_constant__ MeshFrame frame,
                       const int4* __restrict__ list,
                       float* __restrict__ vertices,
                       unsigned* __restrict__ key_hi,
                       unsigned* __restrict__ key_lo,
                       SK* __restrict__ sort_keys, int* __restrict__ indices) {
  __shared__ __align__(16) float corners[STAGED];
  __shared__ unsigned row_bits[MESH_STAGE_ROWS];
  // the occupied cells in raster order: cell l | code << 9, and its first
  // vertex | first triangle << 16 in the tile
  __shared__ uint2 cells[MARCH_TILE_CELLS];
  __shared__ unsigned char vertex_owner[MESH_BATCH_VERTICES];
  __shared__ unsigned char triangle_owner[MESH_BATCH_TRIANGLES];
  __shared__ unsigned warp_sums[2][MESH_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int4 row = __ldg(&list[blockIdx.x]);
  const int x0 = row.x % g * MARCH_TILE, y0 = row.x / g % g * MARCH_TILE,
            z0 = row.x / (g * g) * MARCH_TILE;
  // thread k < 81: corner row k = (z, y), two 16-byte copies and a 4-byte
  // one where the row starts 16-byte aligned, else a 4-byte copy a corner
  // (NaN past the field's end); once its own copies have landed, the row's
  // sign and finite bits
  if (threadIdx.x < MESH_STAGE_ROWS) {
    const int k = threadIdx.x;
    const int y = y0 + k % MARCH_SPAN, z = z0 + k / MARCH_SPAN;
    const bool in = y < b && z < b;
    const float* src = field + ((long long)z * b + y) * b + x0;
    float* dst = corners + k * MESH_STAGE_PITCH;
    const bool whole = in && x0 + 7 < b &&
                       (reinterpret_cast<size_t>(src) & 15u) == 0u;
    if (whole) {
      cp_async16(dst, src);
      cp_async16(dst + 4, src + 4);
    }
#pragma unroll
    for (int x = 0; x < MARCH_SPAN; ++x) {
      if (whole && x < 8) continue;
      if (in && x0 + x < b)
        cp_async4(dst + x, src + x);
      else
        dst[x] = nan_f();
    }
    cp_async_commit();
    cp_async_wait<0>();
    unsigned s = march_sign_bit(dst[8]) << 8,
             f = march_finite_bit(dst[8]) << 8;
    corner_bits4(*reinterpret_cast<const float4*>(dst), 0, s, f);
    corner_bits4(*reinterpret_cast<const float4*>(dst + 4), 4, s, f);
    row_bits[k] = s | (f << 16);
  }
  __syncthreads();

  // thread t: the cells lx .. lx + 3 of row ly of cell plane lz
  const int lz = threadIdx.x / 16, ly = threadIdx.x / 2 % MARCH_TILE,
            lx = MESH_EMIT_CELLS * (threadIdx.x % 2);
  const int ra = lz * MARCH_SPAN + ly, rb = ra + MARCH_SPAN;
  const unsigned r00 = row_bits[ra], r10 = row_bits[ra + 1],
                 r01 = row_bits[rb], r11 = row_bits[rb + 1];
  const int nx = min(max(rx - x0, 0), MARCH_TILE);
  const unsigned occ = mesh_quad_occupied(
      r00, r10, r01, r11, lx,
      y0 + ly < ry && z0 + lz < rz ? (1u << nx) - 1u : 0u);
  // each cell's code and vertices | triangles << 16, and their sum
  unsigned code[MESH_EMIT_CELLS], count[MESH_EMIT_CELLS], mine = 0u;
#pragma unroll
  for (int j = 0; j < MESH_EMIT_CELLS; ++j) {
    code[j] = march_rows_code(r00, r10, r01, r11, lx + j);
    count[j] = (occ >> j) & 1u ? march_vertex_count(code[j]) |
                                     ((march_index_count(code[j]) / 3) << 16)
                               : 0u;
    mine += count[j];
  }
  // the CTA's exclusive prefixes of the occupied cells and of mine
  const unsigned mine_c = (unsigned)__popc(occ);
  unsigned incl = mine, incl_c = mine_c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(FULL, incl, d);
    const unsigned oc = __shfl_up_sync(FULL, incl_c, d);
    if (lane >= d) {
      incl += o;
      incl_c += oc;
    }
  }
  if (lane == 31) {
    warp_sums[0][warp] = incl;
    warp_sums[1][warp] = incl_c;
  }
  __syncthreads();
  unsigned total = 0u, n_cells = 0u, at = incl - mine, at_c = incl_c - mine_c;
#pragma unroll
  for (int w = 0; w < MESH_WARPS; ++w) {
    const unsigned v = warp_sums[0][w], c = warp_sums[1][w];
    total += v;
    n_cells += c;
    at += w < warp ? v : 0u;
    at_c += w < warp ? c : 0u;
  }
#pragma unroll
  for (int j = 0; j < MESH_EMIT_CELLS; ++j) {
    if (!((occ >> j) & 1u)) continue;
    cells[at_c++] = make_uint2(
        (unsigned)(MESH_EMIT_CELLS * threadIdx.x + j) | (code[j] << 9), at);
    at += count[j];
  }
  __syncthreads();

  const long long vertex_at = (unsigned)row.z, index_at = (unsigned)row.w;
  for (unsigned first = 0; first < n_cells; first += MESH_THREADS) {
    // the batch's vertices and triangles in the tile: [base, end)
    const unsigned base = cells[first].y;
    const unsigned end =
        first + MESH_THREADS < n_cells ? cells[first + MESH_THREADS].y : total;
    const unsigned bv = base & 0xFFFFu, bt = base >> 16;
    const unsigned nv = (end & 0xFFFFu) - bv, nt = (end >> 16) - bt;
    const unsigned q = first + threadIdx.x;
    if (q < n_cells) {
      const unsigned from = cells[q].y;
      const unsigned to = q + 1 < n_cells ? cells[q + 1].y : total;
      for (unsigned v = (from & 0xFFFFu) - bv; v < (to & 0xFFFFu) - bv; ++v)
        vertex_owner[v] = (unsigned char)threadIdx.x;
      for (unsigned t = (from >> 16) - bt; t < (to >> 16) - bt; ++t)
        triangle_owner[t] = (unsigned char)threadIdx.x;
    }
    __syncthreads();
    for (unsigned v = threadIdx.x; v < nv; v += MESH_THREADS) {
      const uint2 c = cells[first + vertex_owner[v]];
      const unsigned l = c.x & 0x1FFu, code = c.x >> 9;
      const unsigned ends =
          mesh_vertex_corners(&march_vert_corners_d[0][0], code,
                              (int)(bv + v - (c.y & 0xFFFFu)));
      const unsigned c0 = ends & 0xFu, c1 = ends >> 4;
      const int cx = (int)(l % MARCH_TILE),
                cy = (int)(l / MARCH_TILE % MARCH_TILE),
                cz = (int)(l / (MARCH_TILE * MARCH_TILE));
      const int corner = mesh_staged_corner(cx, cy, cz);
      float pos[3];
      unsigned hi, lo;
      unsigned long long key;
      mesh_vertex(x0 + cx, y0 + cy, z0 + cz, c0, c1,
                  corners[corner + mesh_staged_offset(c0)],
                  corners[corner + mesh_staged_offset(c1)], frame, pos, &hi,
                  &lo, &key);
      const long long a = vertex_at + bv + v;
      key_hi[a] = hi;
      key_lo[a] = lo;
      sort_keys[a] = (SK)key;
#pragma unroll
      for (int k = 0; k < 3; ++k) vertices[3 * a + k] = pos[k];
    }
    for (unsigned t = threadIdx.x; t < nt; t += MESH_THREADS) {
      const uint2 c = cells[first + triangle_owner[t]];
      const unsigned code = c.x >> 9;
      const int k = 3 * (int)(bt + t - (c.y >> 16));
      const int first_vertex = (int)(vertex_at + (c.y & 0xFFFFu));
      int* const out = indices + index_at + 3 * (long long)(bt + t);
#pragma unroll
      for (int m = 0; m < 3; ++m)
        out[m] = first_vertex +
                 mesh_index_vertex(&march_index_d[0][0], code, k + m);
    }
    __syncthreads();  // the owner maps are rewritten by the next batch
  }
}

int tiles_an_axis(int b) { return (b - 1 + MARCH_TILE - 1) / MARCH_TILE; }

// A block the kernels cannot take: 2 <= b <= max_b corners an axis
// (classify and the mesh emission: MESH_MAX_CORNERS; the codes emission:
// 1024, its flat cell ids u32), a region inside it.
bool bad_block(int b, int rx, int ry, int rz, int max_b) {
  return b < 2 || b > max_b || rx < 0 || ry < 0 || rz < 0 || rx > b - 1 ||
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
// occupied cell). `scan_state`: scratch of march_scan_state_words(g^2 *
// ceil(g/8)) 64-bit words, which the classify pass clears for the scan.
// Returns the cudaError_t of the launches.
extern "C" int march_classify_launch(const float* field, int b, int rx,
                                     int ry, int rz, int count_candidates,
                                     unsigned* records, unsigned* rows,
                                     unsigned long long* scan_state,
                                     int* list, long long* totals,
                                     void* stream) {
  if (bad_block(b, rx, ry, rz, MESH_MAX_CORNERS))
    return (int)cudaErrorInvalidValue;
  const int g = tiles_an_axis(b);
  const int segments = march_segments(g);
  const int nrows = g * g * segments;
  const int run_tiles = march_run_tiles(g);
  const int tasks = segments * march_bands(g) * ((g + run_tiles - 1) / run_tiles);
  const cudaStream_t s = (cudaStream_t)stream;
  march_classify_kernel<<<(tasks + CLASSIFY_WARPS - 1) / CLASSIFY_WARPS,
                          CLASSIFY_THREADS, 0, s>>>(
      field, b, g, run_tiles, rx, ry, rz, reinterpret_cast<uint2*>(records),
      reinterpret_cast<uint4*>(rows), scan_state,
      march_scan_state_words(nrows));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  march_scan_kernel<<<march_scan_tiles(nrows), SCAN_THREADS, 0, s>>>(
      reinterpret_cast<const uint4*>(rows), nrows, segments, g,
      reinterpret_cast<const uint2*>(records), count_candidates, scan_state,
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
  if (bad_block(b, rx, ry, rz, 1024) || march_tiles < 0 || m < 0 ||
      vertices < 0)
    return (int)cudaErrorInvalidValue;
  if (march_tiles == 0) return (int)cudaSuccess;
  march_emit_kernel<<<(march_tiles + EMIT_WARPS - 1) / EMIT_WARPS,
                      EMIT_THREADS, 0, (cudaStream_t)stream>>>(
      field, b, tiles_an_axis(b), rx, ry, rz,
      reinterpret_cast<const int4*>(list), march_tiles, m, vertices, image);
  return (int)cudaGetLastError();
}

// march_emit_mesh_launch: the unwelded mesh of the block (b <=
// MESH_MAX_CORNERS corners an axis, cell origin (ox, oy, oz) >= 0) from
// the scan's list of `march_tiles` rows: for each of the totals' vertices
// its position (3 floats) in `vertices`, its key halves in key_hi and
// key_lo, its compact sort key (axis_bits an axis) in sort_keys (4 bytes
// each up to 32 key bits, mesh_sort_key_bytes, else 8), and for each
// triangle index its int32 vertex in `indices`. No rows launch nothing.
extern "C" int march_emit_mesh_launch(const float* field, int b, int rx,
                                      int ry, int rz, long long ox,
                                      long long oy, long long oz,
                                      int axis_bits, const int* list,
                                      int march_tiles, float* vertices,
                                      unsigned* key_hi, unsigned* key_lo,
                                      void* sort_keys, int* indices,
                                      void* stream) {
  if (bad_block(b, rx, ry, rz, MESH_MAX_CORNERS) || march_tiles < 0 ||
      ox < 0 || oy < 0 || oz < 0 || axis_bits < 1 || 3 * axis_bits + 1 > 64)
    return (int)cudaErrorInvalidValue;
  if (march_tiles == 0) return (int)cudaSuccess;
  const MeshFrame frame{{2 * rx, 2 * ry, 2 * rz}, {2 * ox, 2 * oy, 2 * oz},
                        axis_bits};
  const cudaStream_t s = (cudaStream_t)stream;
  const int g = tiles_an_axis(b);
  const int4* rows = reinterpret_cast<const int4*>(list);
  if (mesh_sort_key_bytes(3 * axis_bits + 1) == 4)
    march_emit_mesh_kernel<unsigned><<<march_tiles, MESH_THREADS, 0, s>>>(
        field, b, g, rx, ry, rz, frame, rows, vertices, key_hi, key_lo,
        static_cast<unsigned*>(sort_keys), indices);
  else
    march_emit_mesh_kernel<unsigned long long>
        <<<march_tiles, MESH_THREADS, 0, s>>>(
            field, b, g, rx, ry, rz, frame, rows, vertices, key_hi, key_lo,
            static_cast<unsigned long long*>(sort_keys), indices);
  return (int)cudaGetLastError();
}
