// The binning stage of a block step as three kernels around one library
// sort: the key pass (bin_keys_kernel), the entry gather
// (bin_entries_kernel) and the tile segments (tile_segments_kernel).
//
// They stand for stages the JAX package compiles with XLA:
// mlsgpu_tpu/ops/binning.py::bin_splats (:76; the key pass :95-149, the
// gather :153-157) and ::tile_segments (:161), jitted at
// mlsgpu_tpu/ops/block.py:404-407. Their plain PyTorch versions are
// mlsgpu_tpu_torch/ops/binning.py::splat_keys, ::entry_rows and
// ::tile_segments, which the kernels equal bit for bit (binning.cuh holds
// the arithmetic they share with a host build). The sort between them
// stays torch.sort(stable=True), as the JAX package's lax.sort stays
// outside any kernel. ops/mls_cuda.py builds this file with the other
// kernels into one library; ops/binning_cuda.py calls the C entry points
// below through ctypes, on PyTorch's current stream, without
// synchronising.
//
// What bounds them on the H100, and what the design does about it: all
// of them move a few bytes per operation, so device memory, the latency of
// dependent loads and, at a block's sizes (N ~ 10^5-10^6 splats), the
// launch itself bound them. The plain versions run ~600 elementwise
// launches for the stage, each a round trip through device memory and the
// host's dispatch; the kernels are one launch each (two for the segments,
// from one C call), a thread an item, with the intermediates in
// registers:
//   * bin_keys_kernel: a thread a splat reads its position and radius (one
//     16-byte load of the row's first half) and its valid byte, and writes
//     its 8 int64 keys at c * N + i (coalesced across the warp for each
//     corner c). 33 bytes in, 64 out a splat. Its integer work once
//     bounded it as much as its bytes (int64 Morton interleaves for each
//     of the 8 corners): it spreads each of the 6 axis addresses once, in
//     32 bits, ORs them into the corners' codes, and takes the level's
//     offset from a table in BinShape.
//   * bin_entries_kernel: a thread an entry e of the 8N sorted entries
//     reads the sort's permutation perm[e], writes entry_vals[e] =
//     perm[e] % N and the splat row (two 16-byte loads, cached: each row is
//     read by up to 8 entries) with column 3 set to 1/r^2.
//   * tile_bounds_kernel, then tile_segments_kernel: a segment is the run
//     of a node's key in the sorted keys, so the first finds, for every
//     node key q in [0, K] (K = level_offsets' end), its lower bound
//     LB[q] in a table of K + 1 ints, and the second, a thread a tile,
//     gathers each level's starts = LB[node] and lens = LB[node + 1] -
//     LB[node] from it (the table stays in L2), the tile's code computed
//     once for its levels, the rows written out coalesced through shared
//     memory. A search is a chain of dependent
//     loads, so the bounds pass does one per node instead of two per
//     (tile, level) (each root was searched tpa^3 times), and shortens
//     the chain: a CTA of 256 consecutive q first finds the key range of
//     its q with two 32-ary warp searches (a round is one warp-wide load,
//     ~4 rounds), and each thread then searches only inside that range.
//     No CTA waits on another.
// Indices of keys and splats are 64-bit in the key and entry kernels (8N <
// 2^31 at --max-device-splats 4M, but nothing there relies on it); the
// segments' are 32-bit (the wrapper holds the entries below 2^31), and
// segment starts and lengths are int32, as the plain version casts them.

#include <cuda_runtime.h>

#include "binning.cuh"

namespace {

constexpr int THREADS = 256;
static_assert(BIN_BOUND_THREADS == THREADS, "one CTA size");

__global__ void __launch_bounds__(THREADS)
bin_keys_kernel(const float4* __restrict__ splats,
                const unsigned char* __restrict__ valid, long long n,
                const __grid_constant__ BinShape shape,
                long long* __restrict__ keys) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= n) return;
  const float4 p = __ldg(&splats[2 * i]);  // x, y, z, r of row i
  long long k[8];
  bin_splat_keys(p.x, p.y, p.z, p.w, __ldg(&valid[i]) != 0, shape, k);
  long long* out = keys + i;
#pragma unroll
  for (int c = 0; c < 8; ++c, out += n) *out = k[c];
}

__global__ void __launch_bounds__(THREADS)
bin_entries_kernel(const float4* __restrict__ splats,
                   const long long* __restrict__ perm, long long n,
                   float4* __restrict__ entry_data,
                   long long* __restrict__ entry_vals) {
  const long long e = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (e >= 8 * n) return;
  const long long v = __ldg(&perm[e]) % n;
  float4 a = __ldg(&splats[2 * v]);
  const float4 b = __ldg(&splats[2 * v + 1]);
  a.w = bin_inv_r2(a.w);
  entry_vals[e] = v;
  entry_data[2 * e] = a;
  entry_data[2 * e + 1] = b;
}

// The lower bound of q in sorted keys[0, m), by a warp: 32 probes a round
// (binning.cuh), all lanes in step. Every lane returns it.
__device__ int warp_lower_bound(const long long* __restrict__ keys, int m,
                                long long q) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = m;
  while (lo < hi) {
    const int idx = bin_probe(lo, hi, lane);
    const bool below = idx >= 0 && keys[idx] < q;
    bin_narrow(lo, hi, __popc(__ballot_sync(0xFFFFFFFFu, below)));
  }
  return lo;
}

// bounds[q] = the lower bound of q in sorted keys[0, m), for q in
// [0, nodes]: a CTA the THREADS consecutive q from blockIdx.x * THREADS.
// Every q of the CTA has its bound in [LB(q0), LB(last)], which its first
// two warps find; each thread then searches only that range.
__global__ void __launch_bounds__(THREADS)
tile_bounds_kernel(const long long* __restrict__ keys, int m, int nodes,
                   int* __restrict__ bounds) {
  __shared__ int range[2];
  const int q0 = blockIdx.x * THREADS;
  const int q = q0 + threadIdx.x;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int last = min(q0 + THREADS - 1, nodes);
    const int b = warp_lower_bound(keys, m, warp == 0 ? q0 : last);
    if ((threadIdx.x & 31) == 0) range[warp] = b;
  }
  __syncthreads();
  if (q <= nodes) bounds[q] = bin_lower_bound(keys, range[0], range[1], q);
}

// starts, lens (tpa^3, levels) from the bounds: a thread a tile (its code
// once, then each level's node), the CTA's rows staged in shared memory
// and written out coalesced.
__global__ void __launch_bounds__(THREADS)
tile_segments_kernel(const int* __restrict__ bounds,
                     const __grid_constant__ BinShape shape, unsigned tpa,
                     unsigned tiles, int* __restrict__ starts,
                     int* __restrict__ lens) {
  __shared__ int row_start[THREADS * BIN_MAX_LEVELS];
  __shared__ int row_len[THREADS * BIN_MAX_LEVELS];
  const int levels = shape.max_shift - shape.min_shift + 1;
  const unsigned t0 = blockIdx.x * THREADS;
  const unsigned t = t0 + threadIdx.x;
  if (t < tiles) {
    const unsigned code = bin_tile_code(t, tpa);
    for (int li = 0; li < levels; ++li) {
      const int node = bin_level_node(code, li, shape);
      const int start = __ldg(&bounds[node]);
      row_start[threadIdx.x * levels + li] = start;
      row_len[threadIdx.x * levels + li] = __ldg(&bounds[node + 1]) - start;
    }
  }
  __syncthreads();
  const unsigned n = min((unsigned)THREADS, tiles - t0) * levels;
  for (unsigned k = threadIdx.x; k < n; k += THREADS) {
    starts[t0 * levels + k] = row_start[k];
    lens[t0 * levels + k] = row_len[k];
  }
}

bool bad_shifts(int min_shift, int max_shift) {
  return min_shift < BIN_MIN_SHIFT || max_shift < min_shift ||
         max_shift > BIN_MAX_SHIFT;
}

unsigned int blocks_for(long long items) {
  return (unsigned int)((items + THREADS - 1) / THREADS);
}

}  // namespace

// bin_keys_launch: the (8N,) int64 keys of N splats (N, 8) f32 (16-byte
// aligned) with valid (N,) bytes, for a block at cell origin (ox, oy, oz)
// and node shifts [min_shift, max_shift]. N = 0 launches nothing.
// Returns the cudaError_t of the launch.
extern "C" int bin_keys_launch(const float* splats, const unsigned char* valid,
                               long long n, int min_shift, int max_shift,
                               long long ox, long long oy, long long oz,
                               long long* keys, void* stream) {
  if (n < 0 || bad_shifts(min_shift, max_shift))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  bin_keys_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(splats), valid, n,
      bin_shape(min_shift, max_shift, ox, oy, oz), keys);
  return (int)cudaGetLastError();
}

// bin_entries_launch: from the stable sort's permutation perm (8N,) int64
// of the keys, entry_vals (8N,) int64 = perm % N and entry_data (8N, 8)
// f32, the splat rows in entry order with column 3 = 1/r^2.
extern "C" int bin_entries_launch(const float* splats, const long long* perm,
                                  long long n, float* entry_data,
                                  long long* entry_vals, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  bin_entries_kernel<<<blocks_for(8 * n), THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(splats), perm, n,
      reinterpret_cast<float4*>(entry_data), entry_vals);
  return (int)cudaGetLastError();
}

// bin_segments_launch: for tpa^3 tiles (tpa <= 2^(max_shift - 3)) and the
// levels of [min_shift, max_shift], the segment of each ancestor node in
// the m sorted keys: starts, lens (tpa^3, levels) int32. Two kernels back
// to back on the stream: the bounds of every node key q in [0, K] into
// `bounds` (scratch of K + 1 ints, left holding them), then the
// gather. K = level_offsets' end, 8^(L-1) + ... + 8 + 1 for L levels.
extern "C" int bin_segments_launch(const long long* keys, long long m,
                                   int min_shift, int max_shift, int tpa,
                                   int* bounds, int* starts, int* lens,
                                   void* stream) {
  if (m < 0 || m >= (1LL << 31) || bad_shifts(min_shift, max_shift) ||
      tpa < 1 || tpa > (1 << (max_shift - 3)))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)tpa * tpa * tpa;
  if (tiles * (max_shift - min_shift + 1) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const BinShape shape = bin_shape(min_shift, max_shift, 0, 0, 0);
  const int nodes = bin_nodes(shape);
  const cudaStream_t s = (cudaStream_t)stream;
  tile_bounds_kernel<<<blocks_for(nodes + 1LL), THREADS, 0, s>>>(
      keys, (int)m, nodes, bounds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_segments_kernel<<<blocks_for(tiles), THREADS, 0, s>>>(
      bounds, shape, (unsigned)tpa, (unsigned)tiles, starts, lens);
  return (int)cudaGetLastError();
}
