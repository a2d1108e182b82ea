// MLS signed-distance field on every corner of every occupied 8x8x8-corner
// tile of a block: the Hopper kernel of mlsgpu_tpu_torch.
//
// Replaces the TPU kernel mlsgpu_tpu/ops/mls_pallas.py::_kernel (launched by
// eval_field_pallas). Its plain PyTorch version is
// mlsgpu_tpu_torch/ops/mls.py::eval_field; ops/mls_cuda.py builds this file
// with nvcc (sm_90a) into a shared library and calls the C entry point
// below through ctypes.
//
// What it computes, per tile (one CTA; one corner per thread):
//   * the tile's candidates are its L level segments [start, start+len) of
//     the sorted entry rows (x, y, z, 1/r^2, nx, ny, nz, quality), walked in
//     full (no candidate cap);
//   * splat positions are re-centred on the tile's global origin in one f32
//     subtraction (the seam-safe frame of the JAX kernel);
//   * for corner c: d = (|x|^2 - 2 c.x + |c|^2) / r^2, kept when d < 0.99,
//     weight w = (1-d)^4 * quality; the thread sums w, w x, w |x|^2, w n,
//     w n.x and the hit count in registers;
//   * the moments are re-centred on the corner and the sphere or plane fit
//     with the boundary test gives the signed distance (NaN with < 4 hits or
//     on rejection). The result is written straight into the [z, y, x]
//     field; empty tiles exit at once and keep the NaN the wrapper prefilled.
//
// What bounds it on an H100: every entry of a tile is read once from
// device memory (32 B) and then costs each of the 512 corners ~25 FP32
// operations (distance, weight, 10 FFMA moment updates), so a tile with E
// candidates does ~13k*E flops against 32*E bytes: ~400 flop/byte, far above
// the ~20 flop/byte at which FP32 FFMA issue (67 TFLOP/s without tensor
// cores, which have no FP32 mode) rather than HBM (3.35 TB/s) is the limit.
// The design therefore keeps all per-corner state in registers, stages each
// chunk of entries once per CTA in shared memory (derived per-entry values
// |x|^2 and n.x computed once by the loading thread, not 512 times), and
// reads it back as warp-wide broadcasts (every thread of a warp reads the
// same address: no bank conflicts). No atomics and no split reduction: each
// corner's sums run in the fixed segment order, so a rerun is bitwise
// identical. Staging is synchronous (__syncthreads between chunks);
// cp.async/TMA double buffering is left for a later revision.
//
// The distance uses explicitly rounded operations (no FMA contraction) in
// the plain version's order, so the d < 0.99 decisions match it; only the
// moment sums are accumulated in another order (FFMA, sequential).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 8;
constexpr int TILE_CORNERS = TILE * TILE * TILE;  // one thread per corner
constexpr int CHUNK = TILE_CORNERS;               // entries staged per pass
constexpr int MAX_LEVELS = 16;
constexpr float RADIUS_CUTOFF = 0.99f;            // kernels/mls.cl:36
constexpr int HITS_CUTOFF = 4;                    // kernels/mls.cl:37
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

template <bool PLANE>
__global__ void __launch_bounds__(TILE_CORNERS)
mls_field_kernel(const float* __restrict__ entry,      // (E, 8)
                 const int* __restrict__ seg_starts,   // (T, L)
                 const int* __restrict__ seg_lens,     // (T, L)
                 int levels, int tpa, int ox, int oy, int oz,
                 float boundary_factor,
                 float* __restrict__ field) {          // (8 tpa)^3, [z][y][x]
  // Staged chunk, structure of arrays: re-centred position, 1/r^2, normal,
  // quality, |x|^2, n.x.
  __shared__ float s_x[CHUNK], s_y[CHUNK], s_z[CHUNK], s_ir2[CHUNK];
  __shared__ float s_nx[CHUNK], s_ny[CHUNK], s_nz[CHUNK], s_q[CHUNK];
  __shared__ float s_x2[CHUNK], s_nd[CHUNK];
  __shared__ int s_start[MAX_LEVELS], s_len[MAX_LEVELS];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < levels) {
    s_start[tid] = seg_starts[(size_t)t * levels + tid];
    s_len[tid] = seg_lens[(size_t)t * levels + tid];
  }
  __syncthreads();
  int total = 0;
  for (int li = 0; li < levels; ++li) total += s_len[li];
  if (total == 0) return;  // empty tile: stays NaN (mls.cl:325 early-out)

  const int tz = t / (tpa * tpa);
  const int ty = (t / tpa) % tpa;
  const int tx = t % tpa;
  // Global tile origin; integer coords <= 2^21 are exact in f32.
  const float gx = (float)(tx * TILE + ox);
  const float gy = (float)(ty * TILE + oy);
  const float gz = (float)(tz * TILE + oz);

  const int cx = tid % TILE, cy = (tid / TILE) % TILE, cz = tid / (TILE * TILE);
  const float fcx = (float)cx, fcy = (float)cy, fcz = (float)cz;
  const float cc = dot3(fcx, fcy, fcz, fcx, fcy, fcz);

  float sw = 0.f, sx0 = 0.f, sx1 = 0.f, sx2 = 0.f, sxx = 0.f;
  float sn0 = 0.f, sn1 = 0.f, sn2 = 0.f, snx = 0.f;
  int hits = 0;

  for (int li = 0; li < levels; ++li) {
    const int start = s_start[li];
    const int end = start + s_len[li];
    for (int base = start; base < end; base += CHUNK) {
      const int n = min(CHUNK, end - base);
      if (tid < n) {
        const float4* row =
            reinterpret_cast<const float4*>(entry + (size_t)(base + tid) * 8);
        const float4 a = row[0];
        const float4 b = row[1];
        const float x0 = a.x - gx, x1 = a.y - gy, x2 = a.z - gz;
        s_x[tid] = x0;
        s_y[tid] = x1;
        s_z[tid] = x2;
        s_ir2[tid] = a.w;
        s_nx[tid] = b.x;
        s_ny[tid] = b.y;
        s_nz[tid] = b.z;
        s_q[tid] = b.w;
        s_x2[tid] = dot3(x0, x1, x2, x0, x1, x2);
        s_nd[tid] = dot3(b.x, b.y, b.z, x0, x1, x2);
      }
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        const float x0 = s_x[k], x1 = s_y[k], x2 = s_z[k];
        const float dotcx = dot3(fcx, fcy, fcz, x0, x1, x2);
        const float pp = __fadd_rn(__fsub_rn(s_x2[k], __fmul_rn(2.0f, dotcx)), cc);
        const float d = __fmul_rn(pp, s_ir2[k]);
        if (d < RADIUS_CUTOFF) {
          float w = 1.0f - d;
          w = w * w;
          w = w * w;
          w = w * s_q[k];
          sw += w;
          sx0 = fmaf(w, x0, sx0);
          sx1 = fmaf(w, x1, sx1);
          sx2 = fmaf(w, x2, sx2);
          sxx = fmaf(w, s_x2[k], sxx);
          sn0 = fmaf(w, s_nx[k], sn0);
          sn1 = fmaf(w, s_ny[k], sn1);
          sn2 = fmaf(w, s_nz[k], sn2);
          snx = fmaf(w, s_nd[k], snx);
          ++hits;
        }
      }
      __syncthreads();
    }
  }

  // Re-centre the moments on the corner (exact in the small tile frame).
  const float p0 = sx0 - fcx * sw;
  const float p1 = sx1 - fcy * sw;
  const float p2 = sx2 - fcz * sw;
  const float pp = sxx - 2.0f * dot3(fcx, fcy, fcz, sx0, sx1, sx2) + cc * sw;
  const float pn = snx - dot3(fcx, fcy, fcz, sn0, sn1, sn2);
  const float f = PLANE
      ? plane_distance(sw, p0, p1, p2, pp, sn0, sn1, sn2, pn, hits, boundary_factor)
      : sphere_distance(sw, p0, p1, p2, pp, sn0, sn1, sn2, pn, hits, boundary_factor);

  const size_t b = (size_t)tpa * TILE;
  const size_t z = (size_t)tz * TILE + cz;
  const size_t y = (size_t)ty * TILE + cy;
  const size_t x = (size_t)tx * TILE + cx;
  field[(z * b + y) * b + x] = f;
}

}  // namespace

// C entry point. Launches on `stream` without synchronising and returns the
// launch's cudaError_t (0 = queued). `field` must be prefilled with NaN.
extern "C" int mls_field_launch(const float* entry, const int* seg_starts,
                                const int* seg_lens, int num_tiles,
                                int levels, int tpa, int ox, int oy, int oz,
                                int fit_plane, float boundary_factor,
                                float* field, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const dim3 grid(num_tiles), block(TILE_CORNERS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fit_plane) {
    mls_field_kernel<true><<<grid, block, 0, s>>>(
        entry, seg_starts, seg_lens, levels, tpa, ox, oy, oz,
        boundary_factor, field);
  } else {
    mls_field_kernel<false><<<grid, block, 0, s>>>(
        entry, seg_starts, seg_lens, levels, tpa, ox, oy, oz,
        boundary_factor, field);
  }
  return (int)cudaGetLastError();
}
