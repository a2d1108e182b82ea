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
// three move a few bytes per operation, so device memory and, at a
// block's sizes (N ~ 10^5-10^6 splats), the launch itself bound them.
// The plain versions run ~600 elementwise launches for the stage, each a
// round trip through device memory and the host's dispatch; the kernels
// are one launch each, a thread an item, with the intermediates in
// registers:
//   * bin_keys_kernel: a thread a splat reads its position and radius (one
//     16-byte load of the row's first half) and its valid byte, and writes
//     its 8 int64 keys at c * N + i (coalesced across the warp for each
//     corner c). 33 bytes in, 64 out a splat.
//   * bin_entries_kernel: a thread an entry e of the 8N sorted entries
//     reads the sort's permutation perm[e], writes entry_vals[e] =
//     perm[e] % N and the splat row (two 16-byte loads, cached: each row is
//     read by up to 8 entries) with column 3 set to 1/r^2.
//   * tile_segments_kernel: a thread a (tile, level) computes its node key
//     and two lower-bound searches in the sorted keys (the second from the
//     first's result); the keys' top levels stay in L2 across threads.
// Indices are 64-bit throughout (8N < 2^31 at --max-device-splats 4M, but
// nothing here relies on it); segment starts and lengths are int32, as the
// plain version casts them.

#include <cuda_runtime.h>

#include "binning.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bin_keys_kernel(const float4* __restrict__ splats,
                const unsigned char* __restrict__ valid, long long n,
                BinShape shape, long long* __restrict__ keys) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= n) return;
  const float4 p = __ldg(&splats[2 * i]);  // x, y, z, r of row i
  long long k[8];
  bin_splat_keys(p.x, p.y, p.z, p.w, __ldg(&valid[i]) != 0, shape, k);
#pragma unroll
  for (int c = 0; c < 8; ++c) keys[c * n + i] = k[c];
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

__global__ void __launch_bounds__(THREADS)
tile_segments_kernel(const long long* __restrict__ keys, long long m,
                     int min_shift, int max_shift, int tpa, long long items,
                     int* __restrict__ starts, int* __restrict__ lens) {
  const long long j = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (j >= items) return;
  const int levels = max_shift - min_shift + 1;
  const long long node = bin_tile_node(j / levels, tpa, (int)(j % levels),
                                       min_shift, max_shift);
  const long long start = bin_lower_bound(keys, m, node);
  const long long end =
      start + bin_lower_bound(keys + start, m - start, node + 1);
  starts[j] = (int)start;
  lens[j] = (int)(end - start);
}

bool bad_shifts(int min_shift, int max_shift) {
  return min_shift < 3 || max_shift < min_shift || max_shift > 13;
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
  const BinShape shape{min_shift, max_shift, {ox, oy, oz}};
  bin_keys_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(splats), valid, n, shape, keys);
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

// bin_segments_launch: for tpa^3 tiles and the levels of [min_shift,
// max_shift], the segment of each ancestor node in the m sorted keys:
// starts, lens (tpa^3, levels) int32.
extern "C" int bin_segments_launch(const long long* keys, long long m,
                                   int min_shift, int max_shift, int tpa,
                                   int* starts, int* lens, void* stream) {
  if (m < 0 || tpa < 1 || tpa > 1024 || bad_shifts(min_shift, max_shift))
    return (int)cudaErrorInvalidValue;
  const long long items =
      (long long)tpa * tpa * tpa * (max_shift - min_shift + 1);
  tile_segments_kernel<<<blocks_for(items), THREADS, 0,
                         (cudaStream_t)stream>>>(
      keys, m, min_shift, max_shift, tpa, items, starts, lens);
  return (int)cudaGetLastError();
}
