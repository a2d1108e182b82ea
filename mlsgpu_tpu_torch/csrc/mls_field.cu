// MLS signed-distance field on every corner of every occupied 8x8x8-corner
// tile of a block: the Hopper kernel of mlsgpu_tpu_torch.
//
// Replaces the TPU kernel mlsgpu_tpu/ops/mls_pallas.py::_kernel (launched by
// eval_field_pallas, pallas_call at :257). Its plain PyTorch version is
// mlsgpu_tpu_torch/ops/mls.py::eval_field; ops/mls_cuda.py builds this file
// with nvcc (sm_90a) into a shared library and calls the C entry point
// below through ctypes, on PyTorch's current stream, without synchronising.
//
// What it computes, per occupied tile (four warps' work items, one per
// 8x4x4 box of corners):
//   * the tile's candidates are its L level segments [start, start+len) of
//     the sorted entry rows (x, y, z, 1/r^2, nx, ny, nz, quality), walked in
//     full and in segment order (no candidate cap);
//   * splat positions are re-centred on the tile's global origin in one f32
//     subtraction (the seam-safe frame of the JAX kernel);
//   * for corner c: d = (|x|^2 - 2 c.x + |c|^2) / r^2, kept when d < 0.99,
//     weight w = (1-d)^4 * quality; sums of w, w x, w |x|^2, w n, w n.x and
//     the hit count stay in registers;
//   * the moments are re-centred on the corner and the sphere or plane fit
//     with the boundary test gives the signed distance (NaN with < 4 hits or
//     on rejection), written straight into the [z, y, x] field.
//
// The bound on an H100 (densest 256^3-corner bucket of the 2M-splat bench
// cloud: 663,496 entries, 2,841 of 32,768 tiles occupied, 384,480 candidate
// slots, so 196.9 M corner-entry pairs; 68.2 M of them within reach of
// their 8x4x4 box, 9.04 M with d < 0.99): 9 FP32 operations per reached
// pair for the distance and cutoff, 21 more per hit, and the per-candidate
// re-centring and box tests, 0.84 GFLOP, 12.5 us at 67 TFLOP/s; 21.2 MB of
// entries, 1.6 MB of segments and the 67.1 MB field written once, 27 us at
// 3.35 TB/s. So it is bound by the bytes (chip_smoke.py's kernel_bound
// counts both on each run's inputs).
//
// What held the first design (one CTA of 512 threads per tile, one corner
// per thread) at ~10% of that bound, and what this design does about it:
//   1. Shared-memory load issue: five 32-bit shared loads per candidate per
//      corner, five more on a hit. Here each thread owns four corners that
//      differ only in z, and a candidate is three warp-broadcast loads
//      (float4 x,y,z,1/r^2; float2 |x|^2,n.x; float4 n,q) that feed all
//      four. The partial (cx x0 + cy x1) is shared by the four corners;
//      each adds its own cz x2 in the plain version's rounded order (dot3
//      below), so every d < 0.99 decision is bitwise the plain version's. Most candidates
//      (those of the coarse octree levels) lie far from most of the tile:
//      a warp owns one 8x4x4 box of a tile's corners, tests each staged
//      candidate against the box (a conservative box-distance test), and
//      sums only those it can reach, in row order (a ballot mask). The sums
//      are branch-free: a corner a candidate misses adds a weight of +0,
//      which leaves every sum bit for bit as it was.
//   2. 91% of the CTAs had no candidates. Two small kernels here (a
//      deterministic counting sort, no atomics) list the tiles occupied
//      first, longest first, and count the occupied ones in device memory;
//      a fixed grid of persistent CTAs, sized from the SM count and the
//      occupancy, walks that list and reads the count from device memory
//      (no host sync). On an H100 80GB HBM3 at 700 W the two take ~0.013 ms
//      at the bucket above, their plain version (ops/mls_cuda.py
//      tile_order_plain: sum, stable argsort, count) ~0.13 ms.
//   3. Occupancy and waves: 128 threads per CTA instead of 512, several
//      CTAs per SM; the warps are independent workers (no barrier couples
//      the warps of a CTA, so a warp with a short candidate list moves on)
//      striding over (tile, box) items, the 242-candidate tiles first.
//   4. Synchronous staging: each warp's entry chunks arrive by cp.async
//      into two shared buffers of its own; chunk k+1 is in flight while
//      chunk k is summed (the counterpart of the Pallas kernel's two VMEM
//      windows).
//   5. The NaN prefill: the wrapper no longer fills the field; the warps
//      write NaN into the empty tiles themselves (16-byte stores), so every
//      corner of the field is written exactly once.
// Kept: no atomics and no split reduction; each corner sums its candidates
// in the fixed segment order, so a rerun is bitwise identical. Only the
// moment sums differ from the plain version, in order (FFMA, sequential).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TILE = 8;
constexpr int TILE_CORNERS = TILE * TILE * TILE;
constexpr int ZPT = 4;                              // corners per thread (z)
constexpr int THREADS = TILE_CORNERS / ZPT;         // 128 threads per tile
constexpr int WARPS = THREADS / 32;                 // 4 boxes per tile
constexpr int WARP_CHUNK = 32;                      // entries per stage
constexpr int MAX_LEVELS = 16;
constexpr int MAX_DEVICES = 64;                     // grid sizes cached
constexpr float RADIUS_CUTOFF = 0.99f;              // kernels/mls.cl:36
constexpr int HITS_CUTOFF = 4;                      // kernels/mls.cl:37
constexpr float FLT_EPS = 1.1920929e-07f;

__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  // (a0 b0 + a1 b1) + a2 b2, each product and sum rounded: the order of
  // models/common.py::dot3.
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

__device__ __forceinline__ float solve_quadratic(float a, float b, float c) {
  // Root of ax^2 + bx + c that is larger (a > 0) or smaller (a < 0); NaN if
  // none (kernels/mls.cl:237-248, models/common.py::solve_quadratic).
  float bdet = b + sqrtf(b * b - 4.0f * a * c);
  float x1 = -2.0f * c / bdet;
  float x2 = bdet / (-2.0f * a);
  float x = isfinite(x1) ? x1 : x2;
  return isfinite(x) ? x : nanf("");
}

__device__ __forceinline__ bool boundary_accept(
    float q_den, float sum_wpp, float p0, float p1, float p2, float sum_w,
    float a0, float a1, float a2, float boundary_factor) {
  float aa = dot3(a0, a1, a2, a0, a1, a2);
  float rhs = sum_wpp - 2.0f * dot3(p0, p1, p2, a0, a1, a2) + sum_w * aa;
  return (aa < 3.0f) && (q_den > boundary_factor * rhs);
}

// Algebraic-sphere fit (models/sphere.py) on corner-centred moments.
__device__ float sphere_distance(float sum_w, float p0, float p1, float p2,
                                 float sum_wpp, float n0, float n1, float n2,
                                 float sum_wpn, int hits,
                                 float boundary_factor) {
  float inv = 1.0f / sum_w;
  float m0 = p0 * inv, m1 = p1 * inv, m2 = p2 * inv;
  float q_num = sum_wpn - dot3(m0, m1, m2, n0, n1, n2);
  float q_den = sum_wpp - dot3(m0, m1, m2, p0, p1, p2);
  float q = q_num / q_den;
  bool unstable = fabsf(q_den) < (4.0f * FLT_EPS) * (float)hits * fabsf(sum_wpp);
  if (unstable || !isfinite(q)) q = 0.0f;
  float a = 0.5f * q;
  float b0 = (n0 - q * p0) * inv;
  float b1 = (n1 - q * p1) * inv;
  float b2v = (n2 - q * p2) * inv;
  float c = (-a * sum_wpp - dot3(b0, b1, b2v, p0, p1, p2)) * inv;
  float bb = dot3(b0, b1, b2v, b0, b1, b2v);
  float l = solve_quadratic(a * bb, bb, c);
  float a0 = l * b0, a1 = l * b1, a2 = l * b2v;
  bool accept = boundary_accept(q_den, sum_wpp, p0, p1, p2, sum_w,
                                a0, a1, a2, boundary_factor);
  float f = -dot3(b0, b1, b2v, a0, a1, a2) / sqrtf(bb);
  return (accept && hits >= HITS_CUTOFF) ? f : nanf("");
}

// Weighted-plane fit (models/plane.py); sum_wpn is unused.
__device__ float plane_distance(float sum_w, float p0, float p1, float p2,
                                float sum_wpp, float n0, float n1, float n2,
                                float /*sum_wpn*/, int hits,
                                float boundary_factor) {
  float mean0 = p0 / sum_w, mean1 = p1 / sum_w, mean2 = p2 / sum_w;
  float norm = sqrtf(dot3(n0, n1, n2, n0, n1, n2));
  float u0 = n0 / norm, u1 = n1 / norm, u2 = n2 / norm;
  float dist = -dot3(u0, u1, u2, mean0, mean1, mean2);
  float a0 = u0 * (-dist), a1 = u1 * (-dist), a2 = u2 * (-dist);
  float q_den = sum_wpp - dot3(mean0, mean1, mean2, p0, p1, p2);
  bool accept = boundary_accept(q_den, sum_wpp, p0, p1, p2, sum_w,
                                a0, a1, a2, boundary_factor);
  return (accept && hits >= HITS_CUTOFF) ? dist : nanf("");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
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

// Moments of one corner, summed in registers.
struct Moments {
  float w, x0, x1, x2, xx, n0, n1, n2, nx;
  int hits;
};

// A work item is one warp's share of one occupied tile: the 128 corners
// x 0..7, y 4(w&1)..+3, z 4(w>>1)..+3 of box w (lane: x = lane % 8,
// y = 4(w&1) + lane / 8, four z). Items are numbered 4 * rank + w over the
// tile order, then one item per empty tile (NaN); the warps of the grid
// stride over them. A warp stages, tests and sums on its own: no barrier
// couples it to the other warps of its CTA.
template <bool PLANE>
__global__ void __launch_bounds__(THREADS)
mls_field_kernel(const float* __restrict__ entry,        // (E, 8)
                 const int* __restrict__ seg_starts,     // (T, L)
                 const int* __restrict__ seg_lens,       // (T, L)
                 const int* __restrict__ order,          // (T,) longest first
                 const int* __restrict__ num_occupied,   // scalar, on device
                 int num_tiles, int levels, int tpa, int ox, int oy, int oz,
                 float boundary_factor,
                 float* __restrict__ field) {            // (8 tpa)^3 [z][y][x]
  // Per warp: two stages of WARP_CHUNK raw entry rows (cp.async targets):
  // s_a = (x, y, z, 1/r^2), re-centred in place once arrived, s_b = (nx,
  // ny, nz, q), s_c = (|x|^2, n.x); and the tile's level segments.
  __shared__ __align__(16) float4 s_a[WARPS][2][WARP_CHUNK];
  __shared__ __align__(16) float4 s_b[WARPS][2][WARP_CHUNK];
  __shared__ __align__(16) float2 s_c[WARPS][WARP_CHUNK];
  __shared__ int s_start[WARPS][MAX_LEVELS], s_pref[WARPS][MAX_LEVELS + 1];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_occ = *num_occupied;
  const int num_items = 4 * n_occ + (num_tiles - n_occ);
  const int warps = gridDim.x * WARPS;
  const size_t b = (size_t)tpa * TILE;
  int* const start = s_start[warp];
  int* const pref = s_pref[warp];

  for (int k = blockIdx.x * WARPS + warp; k < num_items; k += warps) {
    const bool empty = k >= 4 * n_occ;
    const int t = order[empty ? k - 3 * n_occ : k / 4];
    const int tz = t / (tpa * tpa);
    const int ty = (t / tpa) % tpa;
    const int tx = t % tpa;
    if (empty) {                 // undefined everywhere: 4 x 16 bytes/lane
      const float q = nanf("");
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r * 32 + lane;   // 128 half rows of 4 corners
        float4* p = reinterpret_cast<float4*>(
            field + (((size_t)tz * TILE + row / 16) * b
                     + (size_t)ty * TILE + (row / 2) % TILE) * b
            + (size_t)tx * TILE + (row % 2) * 4);
        *p = make_float4(q, q, q, q);
      }
      continue;
    }
    const int w = k % 4;
    const int cx = lane % TILE, cy = 4 * (w & 1) + lane / TILE;
    const int cz0 = 4 * (w >> 1);
    const float fcx = (float)cx, fcy = (float)cy;
    // The box's bounds in the tile frame, for the reach test.
    const float by0 = (float)(4 * (w & 1)), bz0 = (float)cz0;

    __syncwarp();                // the previous item is done with s_*
    int len = 0;
    if (lane < levels) {
      start[lane] = seg_starts[(size_t)t * levels + lane];
      len = seg_lens[(size_t)t * levels + lane];
    }
    int incl = len;              // inclusive scan of the level lengths
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane < levels) pref[lane] = incl - len;
    const int total = __shfl_sync(0xffffffffu, incl, levels - 1);
    if (lane == 0) pref[levels] = total;
    __syncwarp();
    const int num_chunks = (total + WARP_CHUNK - 1) / WARP_CHUNK;

    // Global tile origin; integer coords <= 2^21 are exact in f32.
    const float gx = (float)(tx * TILE + ox);
    const float gy = (float)(ty * TILE + oy);
    const float gz = (float)(tz * TILE + oz);

    // Stage chunk `c` into buffer c & 1: this lane's row is candidate slot
    // c * WARP_CHUNK + lane, found by walking the level segments.
    auto issue = [&](int c) {
      const int p = c * WARP_CHUNK + lane;
      if (p < total) {
        int li = 0;
        while (p >= pref[li + 1]) ++li;
        const float* row = entry + (size_t)(start[li] + p - pref[li]) * 8;
        cp_async16(&s_a[warp][c & 1][lane], row);
        cp_async16(&s_b[warp][c & 1][lane], row + 4);
      }
      cp_async_commit();
    };

    Moments m[ZPT];
#pragma unroll
    for (int j = 0; j < ZPT; ++j) m[j] = Moments{0.f, 0.f, 0.f, 0.f, 0.f,
                                                  0.f, 0.f, 0.f, 0.f, 0};

    issue(0);
    for (int c = 0; c < num_chunks; ++c) {
      const int buf = c & 1;
      if (c + 1 < num_chunks) {
        issue(c + 1);            // in flight while chunk c is summed
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      const int n = min(WARP_CHUNK, total - c * WARP_CHUNK);
      bool reach = false;
      if (lane < n) {            // re-centre this lane's own row
        const float4 a = s_a[warp][buf][lane];
        const float4 nq = s_b[warp][buf][lane];
        const float x0 = a.x - gx, x1 = a.y - gy, x2 = a.z - gz;
        const float xx = dot3(x0, x1, x2, x0, x1, x2);
        s_a[warp][buf][lane] = make_float4(x0, x1, x2, a.w);
        s_c[warp][lane] = make_float2(xx, dot3(nq.x, nq.y, nq.z, x0, x1, x2));
        // A candidate whose squared distance to the box, less an allowance
        // ~10x the rounding error of the expanded distance form, is at
        // least the cutoff misses every corner of the box: the warp skips
        // it, and the corners' own decisions are unchanged.
        const float slack = 4e-6f * (xx + 150.0f);
        const float ex = fmaxf(fmaxf(-x0, x0 - 7.0f), 0.0f);
        const float ey = fmaxf(fmaxf(by0 - x1, x1 - (by0 + 3.0f)), 0.0f);
        const float ez = fmaxf(fmaxf(bz0 - x2, x2 - (bz0 + 3.0f)), 0.0f);
        const float dist2 = ex * ex + ey * ey + ez * ez;
        reach = !((dist2 - slack) * a.w >= RADIUS_CUTOFF);
      }
      // The reachable rows in row order, so every corner still sums its
      // candidates in the fixed segment order.
      unsigned todo = __ballot_sync(0xffffffffu, reach);
      __syncwarp();
      // Branch-free sums: a corner the candidate misses adds a weight of
      // +0, which leaves every sum bit for bit as it was.
      while (todo) {
        const int e = __ffs(todo) - 1;
        todo &= todo - 1;
        const float4 a = s_a[warp][buf][e];
        const float2 cc2 = s_c[warp][e];
        const float4 nq = s_b[warp][buf][e];
        const float part = __fadd_rn(__fmul_rn(fcx, a.x), __fmul_rn(fcy, a.y));
#pragma unroll
        for (int j = 0; j < ZPT; ++j) {
          const float fcz = (float)(cz0 + j);
          const float cc = dot3(fcx, fcy, fcz, fcx, fcy, fcz);
          const float dotcx = __fadd_rn(part, __fmul_rn(fcz, a.z));
          // x2 - 2 dotcx rounded once: 2 dotcx is exact, so the fused form
          // equals the plain version's subtraction bit for bit.
          const float pp = __fadd_rn(__fmaf_rn(-2.0f, dotcx, cc2.x), cc);
          const float d = __fmul_rn(pp, a.w);
          const bool hit = d < RADIUS_CUTOFF;
          float wt = 1.0f - d;
          wt = wt * wt;
          wt = wt * wt;
          wt = hit ? wt * nq.w : 0.0f;
          m[j].w += wt;
          m[j].x0 = fmaf(wt, a.x, m[j].x0);
          m[j].x1 = fmaf(wt, a.y, m[j].x1);
          m[j].x2 = fmaf(wt, a.z, m[j].x2);
          m[j].xx = fmaf(wt, cc2.x, m[j].xx);
          m[j].n0 = fmaf(wt, nq.x, m[j].n0);
          m[j].n1 = fmaf(wt, nq.y, m[j].n1);
          m[j].n2 = fmaf(wt, nq.z, m[j].n2);
          m[j].nx = fmaf(wt, cc2.y, m[j].nx);
          m[j].hits += hit;
        }
      }
      __syncwarp();              // the buffers are reused two chunks on
    }

    float* out = field + (((size_t)tz * TILE + cz0) * b
                          + (size_t)ty * TILE + cy) * b
                 + (size_t)tx * TILE + cx;
#pragma unroll
    for (int j = 0; j < ZPT; ++j) {
      // Re-centre the moments on the corner (exact in the small tile frame).
      const float fcz = (float)(cz0 + j);
      const float cc = dot3(fcx, fcy, fcz, fcx, fcy, fcz);
      const float p0 = m[j].x0 - fcx * m[j].w;
      const float p1 = m[j].x1 - fcy * m[j].w;
      const float p2 = m[j].x2 - fcz * m[j].w;
      const float pp = m[j].xx - 2.0f * dot3(fcx, fcy, fcz, m[j].x0, m[j].x1,
                                             m[j].x2) + cc * m[j].w;
      const float pn = m[j].nx - dot3(fcx, fcy, fcz, m[j].n0, m[j].n1,
                                      m[j].n2);
      out[(size_t)j * b * b] = PLANE
          ? plane_distance(m[j].w, p0, p1, p2, pp, m[j].n0, m[j].n1, m[j].n2,
                           pn, m[j].hits, boundary_factor)
          : sphere_distance(m[j].w, p0, p1, p2, pp, m[j].n0, m[j].n1, m[j].n2,
                            pn, m[j].hits, boundary_factor);
    }
  }
}

// ---------------------------------------------------------------- tile order
// The tiles, occupied ones first and longest first, as a deterministic
// counting sort (no atomics): a tile's class is ORDER_CLASSES - 1 when it is
// empty, else 7 - min(total / 32, 7), so tiles of 224 or more candidates
// come first; inside a class, tiles keep ascending id. Two passes over
// ORDER_BLOCKS contiguous spans of tiles: class counts per span, then the
// scatter, each span finding its offsets from all spans' counts.
constexpr int ORDER_BLOCKS = 64;
constexpr int ORDER_THREADS = 256;
constexpr int ORDER_CLASSES = 9;

__device__ __forceinline__ int tile_class(const int* seg_lens, int t,
                                          int levels) {
  int total = 0;
  for (int li = 0; li < levels; ++li) total += seg_lens[(size_t)t * levels + li];
  return total == 0 ? ORDER_CLASSES - 1 : 7 - min(total / 32, 7);
}

__global__ void __launch_bounds__(ORDER_THREADS)
tile_class_counts(const int* __restrict__ seg_lens, int num_tiles, int levels,
                  int span, int* __restrict__ counts) {  // (BLOCKS, CLASSES)
  __shared__ int s_warp[ORDER_THREADS / 32][ORDER_CLASSES];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int local[ORDER_CLASSES] = {};
  const int lo = blockIdx.x * span, hi = min(lo + span, num_tiles);
  for (int t = lo + tid; t < hi; t += ORDER_THREADS) {
    const int c = tile_class(seg_lens, t, levels);
#pragma unroll
    for (int k = 0; k < ORDER_CLASSES; ++k) local[k] += (c == k);
  }
#pragma unroll
  for (int k = 0; k < ORDER_CLASSES; ++k) {   // integer sums: any order
    int v = local[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) s_warp[warp][k] = v;
  }
  __syncthreads();
  if (tid < ORDER_CLASSES) {
    int v = 0;
    for (int w = 0; w < ORDER_THREADS / 32; ++w) v += s_warp[w][tid];
    counts[blockIdx.x * ORDER_CLASSES + tid] = v;
  }
}

__global__ void __launch_bounds__(ORDER_THREADS)
tile_order_scatter(const int* __restrict__ seg_lens, int num_tiles,
                   int levels, int span, const int* __restrict__ counts,
                   int* __restrict__ order, int* __restrict__ num_occupied) {
  __shared__ int s_next[ORDER_CLASSES];     // next free slot of each class
  __shared__ int s_warp[ORDER_THREADS / 32][ORDER_CLASSES];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid < ORDER_CLASSES) {
    int base = 0;
    for (int k = 0; k < tid; ++k)
      for (int blk = 0; blk < ORDER_BLOCKS; ++blk)
        base += counts[blk * ORDER_CLASSES + k];
    for (int blk = 0; blk < (int)blockIdx.x; ++blk)
      base += counts[blk * ORDER_CLASSES + tid];
    s_next[tid] = base;
    if (blockIdx.x == 0 && tid == ORDER_CLASSES - 1) *num_occupied = base;
  }
  __syncthreads();
  const int lo = blockIdx.x * span, hi = min(lo + span, num_tiles);
  for (int r = lo; r < hi; r += ORDER_THREADS) {   // rounds of 256 tiles
    const int t = r + tid;
    const int c = t < hi ? tile_class(seg_lens, t, levels) : -1;
    int rank = 0;
#pragma unroll
    for (int k = 0; k < ORDER_CLASSES; ++k) {
      const unsigned bal = __ballot_sync(0xffffffffu, c == k);
      if (lane == 0) s_warp[warp][k] = __popc(bal);
      if (c == k) rank = __popc(bal & ((1u << lane) - 1u));
    }
    __syncthreads();
    if (c >= 0) {
      int at = s_next[c] + rank;
      for (int w = 0; w < warp; ++w) at += s_warp[w][c];
      order[at] = t;
    }
    __syncthreads();
    if (tid < ORDER_CLASSES)
      for (int w = 0; w < ORDER_THREADS / 32; ++w) s_next[tid] += s_warp[w][tid];
    __syncthreads();
  }
}

template <bool PLANE>
int launch_kernel(const float* entry, const int* seg_starts,
                  const int* seg_lens, const int* order,
                  const int* num_occupied, int num_tiles, int levels, int tpa,
                  int ox, int oy, int oz, float boundary_factor, float* field,
                  cudaStream_t stream) {
  // Persistent grid: as many CTAs as fit on the current device at once (a
  // property of the device and the kernel, asked once per device; threads
  // that race to ask store the same value).
  static std::atomic<int> cached[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int resident = dev < MAX_DEVICES ? cached[dev].load() : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mls_field_kernel<PLANE>, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < MAX_DEVICES) cached[dev].store(resident);
  }
  const int grid = num_tiles < resident ? num_tiles : resident;
  mls_field_kernel<PLANE><<<grid, THREADS, 0, stream>>>(
      entry, seg_starts, seg_lens, order, num_occupied, num_tiles, levels,
      tpa, ox, oy, oz, boundary_factor, field);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points. Each launches on `stream` without synchronising and
// returns the launches' cudaError_t (0 = queued).
//
// mls_tile_order_launch: the tile order the field kernel walks. `counts`
// is scratch of mls_tile_order_scratch() ints; `order` (num_tiles ints)
// receives the tile ids, occupied ones first, longest first, and
// `num_occupied` (one int, in device memory) their count.
extern "C" int mls_tile_order_scratch() {
  return ORDER_BLOCKS * ORDER_CLASSES;
}

extern "C" int mls_tile_order_launch(const int* seg_lens, int num_tiles,
                                     int levels, int* counts, int* order,
                                     int* num_occupied, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int span = (num_tiles + ORDER_BLOCKS - 1) / ORDER_BLOCKS;
  tile_class_counts<<<ORDER_BLOCKS, ORDER_THREADS, 0, s>>>(
      seg_lens, num_tiles, levels, span, counts);
  tile_order_scatter<<<ORDER_BLOCKS, ORDER_THREADS, 0, s>>>(
      seg_lens, num_tiles, levels, span, counts, order, num_occupied);
  return (int)cudaGetLastError();
}

// mls_field_launch: the field. `order` and `num_occupied` are
// mls_tile_order_launch's; every corner of `field` is written.
extern "C" int mls_field_launch(const float* entry, const int* seg_starts,
                                const int* seg_lens, const int* order,
                                const int* num_occupied, int num_tiles,
                                int levels, int tpa, int ox, int oy, int oz,
                                int fit_plane, float boundary_factor,
                                float* field, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fit_plane
      ? launch_kernel<true>(entry, seg_starts, seg_lens, order, num_occupied,
                            num_tiles, levels, tpa, ox, oy, oz,
                            boundary_factor, field, s)
      : launch_kernel<false>(entry, seg_starts, seg_lens, order, num_occupied,
                             num_tiles, levels, tpa, ox, oy, oz,
                             boundary_factor, field, s);
}
