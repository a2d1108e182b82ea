// The binning stage of a block step as hand kernels: the key pass
// (bin_keys_kernel), the stable radix sort of the keys
// (bin_sort_histogram_kernel, then bin_sort_pass_kernel a digit), the
// entry gather (bin_entries_kernel) and the tile segments
// (tile_bounds_kernel, tile_segments_kernel).
//
// They stand for stages the JAX package compiles with XLA:
// mlsgpu_tpu/ops/binning.py::bin_splats (:76; the key pass :95-149, the
// sort `jax.lax.sort((all_keys, all_vals), num_keys=1)` :151, stable by
// default, the gather :153-157) and ::tile_segments (:161), jitted at
// mlsgpu_tpu/ops/block.py:404-407. Their plain PyTorch versions are
// mlsgpu_tpu_torch/ops/binning.py::splat_keys, ::radix_sort (whose
// result is torch.sort(stable=True)'s), ::entry_rows and ::tile_segments,
// which the kernels equal bit for bit (binning.cuh holds the arithmetic
// they share with a host build, radix_sort.cuh the sort's kernel bodies,
// which the weld's sort shares, scan.cuh the sort's look-back scan).
// ops/mls_cuda.py builds this file with the other kernels into one
// library; ops/binning_cuda.py calls the C entry points below through
// ctypes, on PyTorch's current stream, without synchronising.
//
// What bounds them on the H100, and what the design does about it: all
// of them move a few bytes per operation, so device memory, the latency of
// dependent loads and, at a block's sizes (N ~ 10^5-10^6 splats), the
// launch itself bound them. The plain versions run ~600 elementwise
// launches for the stage, each a round trip through device memory and the
// host's dispatch; the kernels are one launch each (two for the segments
// and one and a pass for the sort, each from one C call), with the
// intermediates in registers and shared memory:
//   * bin_keys_kernel: a thread a splat reads its position and radius (one
//     16-byte load of the row's first half) and its valid byte, and writes
//     its 8 int64 keys at c * N + i (coalesced across the warp for each
//     corner c). 33 bytes in, 64 out a splat. Its integer work once
//     bounded it as much as its bytes (int64 Morton interleaves for each
//     of the 8 corners): it spreads each of the 6 axis addresses once, in
//     32 bits, ORs them into the corners' codes, and takes the level's
//     offset from a table in BinShape.
//   * the sort: every valid key is below K = the node keys of the
//     block's levels (37,449 at 6 levels, 299,593 at 7), and INVALID_KEY
//     sorts as K, so a key has bit_length(K) bits: an LSD radix sort of
//     8-bit digits takes 2 passes at 6 levels and 3 at 7, where
//     torch.sort of the int64 keys took 11 launches. A histogram kernel
//     reads the keys once and counts every pass's digits (shared-memory
//     counts, a warp's equal digits added once, then one global add a
//     digit a CTA); it also clears the passes' scan state. Then a kernel a
//     pass, a CTA a ticketed tile of 4,096 keys (radix_sort.cuh): at 256^3
//     the tiles run in one wave, so a CTA's chain of dependent steps, not
//     bytes, sets a pass's time. It loads its keys while it takes its
//     ticket (tile blockIdx.x's, reloaded where the ticket differs), ranks
//     them by digit stably in shared memory (match.any finds a warp's
//     lanes of equal digit), publishes its digit counts and finds the
//     lower tiles' (scan.cuh): a pass of about one wave (at most 256
//     tiles; 162 at 256^3) on two levels (32-bit words; a group's first
//     tile over the groups of 16 tiles below, the others from their
//     group's prefix and lower tiles, one round), a larger one (757 at
//     512^3) by the decoupled look-back, which holds fewer registers; it
//     stages the tile in digit order and writes it out coalesced. Keys
//     travel as 32-bit mapped keys and indices as int32
//     between the passes (8N < 2^31); the first pass reads the int64
//     keys, the last writes the int64 sorted keys and permutation. The
//     counts are integers, so the result is torch.sort(stable=True)'s bit
//     for bit whatever the CTAs' timing.
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
#include "scan.cuh"

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

// --- the radix sort ----------------------------------------------------

// The sort's kernels: radix_sort.cuh's bodies on 32-bit sort keys, the
// node keys mapped (BinNodeMap). The histogram kernel reads
// SORT_HIST_ITEMS keys a thread, half a pass tile a CTA, which took
// 0.0048-0.0051 / 0.0208-0.0211 ms at 256^3 / 512^3 on the H100, against
// 0.0073 / 0.0289 with a whole tile and 0.0056 / 0.0193 with a quarter.
constexpr int HIST_KEYS = SORT_THREADS * SORT_HIST_ITEMS;

__global__ void __launch_bounds__(SORT_THREADS)
bin_sort_histogram_kernel(const long long* __restrict__ keys, int n,
                          const __grid_constant__ BinSortPlan plan,
                          unsigned* __restrict__ hist,
                          unsigned long long* __restrict__ state,
                          long long state_words) {
  sort_histogram_body<unsigned, BinNodeMap>(keys, n, plan, hist, state,
                                            state_words);
}

template <bool FIRST, bool LAST, bool GROUPED>
__global__ void __launch_bounds__(SORT_THREADS)
bin_sort_pass_kernel(const void* __restrict__ keys_in,
                     const int* __restrict__ idx_in, int n,
                     const __grid_constant__ BinSortPlan plan, int pass,
                     const unsigned* __restrict__ hist,
                     unsigned long long* state, void* __restrict__ keys_out,
                     void* __restrict__ idx_out) {
  sort_pass_body<unsigned, BinNodeMap, FIRST, LAST, GROUPED>(
      keys_in, idx_in, n, plan, pass, hist, state, keys_out, idx_out);
}

// The pass kernel for the first and last passes and the look-back.
template <bool GROUPED>
auto bin_sort_pass(bool first, bool last) {
  return first ? (last ? bin_sort_pass_kernel<true, true, GROUPED>
                       : bin_sort_pass_kernel<true, false, GROUPED>)
               : (last ? bin_sort_pass_kernel<false, true, GROUPED>
                       : bin_sort_pass_kernel<false, false, GROUPED>);
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

// bin_sort_launch: the n int64 node keys of a block of node shifts
// [min_shift, max_shift] (each a key of those shifts or BIN_INVALID_KEY;
// n < 2^31) sorted stably: `sorted` (n int64, BIN_INVALID_KEY last) and
// `perm` (n int64, equal keys in ascending index), torch.sort(keys,
// stable=True)'s values and indices. On the stream: a memset of the
// histograms, the histogram kernel, then a pass kernel a digit
// (bin_sort_plan: 2 at 6 levels, 3 at 7). `work`: 2n ints for the passes
// between (keys, then indices; none for one pass), `scratch`:
// bin_sort_scratch_words(n, passes) 64-bit words. The pass before the
// last writes into `work` and the one before that into the outputs'
// memory (as 32-bit keys and indices), and so on back, so that no pass
// reads what it writes. n = 0 launches nothing.
extern "C" int bin_sort_launch(const long long* keys, long long n,
                               int min_shift, int max_shift,
                               long long* sorted, long long* perm, int* work,
                               unsigned long long* scratch, void* stream) {
  if (n < 0 || n >= (1LL << 31) || bad_shifts(min_shift, max_shift))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const BinSortPlan plan = bin_sort_plan(min_shift, max_shift);
  if (plan.passes > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  const unsigned tiles = (unsigned)bin_sort_tiles(n);
  const long long pass_words = bin_sort_pass_words(n);
  unsigned* hist = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* state = scratch + plan.passes * (SORT_RADIX / 2);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      hist, 0, sizeof(unsigned) * SORT_RADIX * plan.passes, s);
  if (err != cudaSuccess) return (int)err;
  bin_sort_histogram_kernel<<<(unsigned)((n + HIST_KEYS - 1) / HIST_KEYS),
                              SORT_THREADS, 0, s>>>(
      keys, (int)n, plan, hist, state, plan.passes * pass_words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const void* in_keys = keys;
  const int* in_idx = nullptr;
  for (int p = 0; p < plan.passes; ++p) {
    const bool first = p == 0, last = p == plan.passes - 1;
    const bool to_work = !last && (plan.passes - 2 - p) % 2 == 0;
    void* out_keys = to_work ? static_cast<void*>(work) : sorted;
    void* out_idx = to_work ? static_cast<void*>(work + n) : perm;
    auto kernel = sort_grouped(tiles) ? bin_sort_pass<true>(first, last)
                                      : bin_sort_pass<false>(first, last);
    kernel<<<tiles, SORT_THREADS, 0, s>>>(in_keys, in_idx, (int)n, plan, p,
                                          hist, state + p * pass_words,
                                          out_keys, out_idx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    in_keys = out_keys;
    in_idx = static_cast<const int*>(out_idx);
  }
  return (int)cudaSuccess;
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
