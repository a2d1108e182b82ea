// The weld and the pack of the packed and raw readbacks as hand kernels:
// the weld's radix sort of the compact vertex keys over their top digits
// (weld_sort_histogram_kernel, then weld_sort_pass_kernel a digit), the
// group kernel that finishes the sort and compacts (weld_group_kernel),
// and the image (pack_readback_kernel). The unwelded mesh they take comes
// from marching.cu's classify, scan and march_emit_mesh_kernel.
//
// They stand for programs the JAX package compiles with XLA:
// mlsgpu_tpu/ops/weld.py::weld (:34) and mlsgpu_tpu/ops/block.py::
// _pack_readback (:205), jitted at mlsgpu_tpu/ops/block.py:647-656. Their
// plain PyTorch versions are mlsgpu_tpu_torch/ops/weld.py::weld and
// mlsgpu_tpu_torch/ops/block.py::pack_readback, which the kernels equal
// bit for bit (mesh.cuh holds the arithmetic and the weld's plan they
// share with a host build, radix_sort.cuh the passes, scan.cuh the
// look-back scan). ops/mls_cuda.py builds this file with the other kernels
// into one library; ops/mesh_cuda.py calls the C entry points below
// through ctypes, on PyTorch's current stream, without synchronising: the
// wrapper's one sync is the copy of the welded counts, which size the
// image.
//
// What bounds them on the H100, and what the design does about it: each
// moves a few bytes a vertex or a triangle and does a handful of integer
// and float operations on them, so device memory and, at a block's sizes
// (~10^5-10^6 vertices), the latency of a launch's chain bound them.
//   * the sort: the plain weld sorts the 64-bit (hi, lo) keys; the kernels
//     sort the compact keys (mesh.cuh), 3 axis_bits + 1 bits, block-local
//     (ext, kz, ky, kx), so once they are in order by their top bits each
//     run of equal top bits (a key group) is small: g global passes of
//     8-bit digits over the top 8 g bits only (mesh.cuh's plan: 3 at 28
//     and 31 bits, 256^3 and 512^3; 4-5 at 34-43), each reading and
//     writing every key and index in device memory (32-bit keys between
//     passes, 64-bit above 32 bits; int32 indices), a tile of 4,096 keys
//     a CTA (2,048 with 64-bit keys), on binning's pass body (its keys
//     in flight while it takes its ticket; the two-level look-back of
//     scan.cuh for 190 tiles at 256^3, the decoupled one for 1,180 at
//     512^3). The histogram kernel counts those g digits and clears the
//     passes' and the group kernel's scan state.
//   * weld_group_kernel: a CTA a ticketed tile of 2,048 positions of the
//     top-sorted keys; it owns every group that starts in the tile and
//     reads on past the tile's end to that group's end, its keys (as local
//     words: the free bits under the external flag) and indices loaded
//     coalesced into dynamic shared memory. It finishes the sort stably by
//     the free bits there, nothing to device memory: a warp ranks every
//     group inside a window of 32 slots at once, a ballot a free bit
//     (groups average 10 keys at 256^3 and 6.5 at 512^3); a group that
//     crosses a window's edge is ranked alone, a local digit at a time
//     (match.any ranks, the warp's histogram) where it has more than 32
//     keys. Then the first of each run of equal keys is a welded vertex:
//     a CTA scan of the runs lists each run's first slot and each slot's
//     run in the freed buffer, and a look-back over lower tiles by a warp
//     a count (scan.cuh, 32 tiles a round: the CTAs publish in waves) of
//     three counts (welded vertices, those internal: the external flag is
//     the key's top bit, so externals come last; groups past the
//     capacity) gives the range's first welded index. The
//     representatives' positions and key halves (the run's first key, its
//     lowest emission index: the stable sort's representative) are loaded
//     before the look-back, 4 runs a thread; the welded vertices and key
//     halves are written a run a thread, consecutive threads to
//     consecutive vertices, then the old -> new remap of every slot; the
//     last tile writes the totals. A group past the capacity is counted,
//     not welded: the wrapper raises on that count.
//   * pack_readback_kernel: a thread a welded vertex (its 3 or 4 u16
//     words) and a thread a triangle (its remapped indices, as u16, u21x3
//     or u32 words), one launch over both ranges, written as halfwords
//     and words into the image's final layout (a halfword shared by two
//     threads is never read, modified and written); the pad halfwords
//     zero. Raw readback runs it as the triangles' remap alone, into int32
//     triangles.

#include <cuda_runtime.h>

#include <atomic>

#include "mesh.cuh"
#include "radix_sort.cuh"
#include "scan.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int HIST_KEYS = SORT_THREADS * SORT_HIST_ITEMS;
constexpr int G_THREADS = MESH_WELD_THREADS;
constexpr int G_WARPS = G_THREADS / 32;
constexpr int G_TILE = MESH_WELD_TILE;
constexpr int G_LOAD = G_TILE / G_THREADS;
constexpr int G_ITEMS = MESH_WELD_ITEMS;
constexpr int G_ROUND = MESH_WELD_ROUND;
constexpr int G_BINS = 1 << MESH_WELD_LOCAL_BITS;
constexpr int G_OVER = 4;   // chunks of the overhang's loads in flight
constexpr int G_REPS = 4;   // welded vertices a thread loads before the
                            // look-back
constexpr unsigned EXT_WORD = 1u << 31;
constexpr int G_WORDS = G_TILE / 32 / 32;   // start words a lane of warp 0
static_assert(G_TILE % G_THREADS == 0 && G_TILE % 1024 == 0,
              "a tile's load: whole start words a warp, a lane");

// --- the sort ----------------------------------------------------------

// The emission writes the compact keys at their sort width (K: 4 bytes up
// to 32 bits, mesh_sort_key_bytes), so the histogram and the first pass
// read them as K.
template <typename K>
__global__ void __launch_bounds__(SORT_THREADS)
weld_sort_histogram_kernel(const K* __restrict__ keys, int n,
                           const __grid_constant__ SortPlan plan,
                           unsigned* __restrict__ hist,
                           unsigned long long* __restrict__ state,
                           long long state_words) {
  sort_histogram_body<K, SortIdentity<K>, K>(keys, n, plan, hist, state,
                                             state_words);
}

template <typename K, bool FIRST, bool GROUPED>
__global__ void __launch_bounds__(SORT_THREADS)
weld_sort_pass_kernel(const void* __restrict__ keys_in,
                      const int* __restrict__ idx_in, int n,
                      const __grid_constant__ SortPlan plan, int pass,
                      const unsigned* __restrict__ hist,
                      unsigned long long* state, void* __restrict__ keys_out,
                      void* __restrict__ idx_out) {
  sort_pass_body<K, SortIdentity<K>, FIRST, false, GROUPED, K>(
      keys_in, idx_in, n, plan, pass, hist, state, keys_out, idx_out);
}

// The sort's launches on the stream, on n keys of K each: a memset of the
// histograms, the histogram kernel (which also clears `extra_words` words
// of state after the passes'), then a pass kernel a top digit, each
// writing K keys and int32 indices into one of the work buffers (`buffer`
// int32 words each): the last into the first buffer, the one before it
// into the second, and so on back, so that no pass reads what it writes.
template <typename K>
cudaError_t weld_sort(const K* keys, int n, const SortPlan& plan,
                      int* work, long long buffer,
                      unsigned long long* scratch, long long extra_words,
                      cudaStream_t s) {
  const int kb = (int)sizeof(K);
  const unsigned tiles = (unsigned)sort_tiles(n, kb);
  const long long pass_words = sort_pass_words(n, kb);
  unsigned* hist = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* state = scratch + plan.passes * (SORT_RADIX / 2);
  cudaError_t err = cudaMemsetAsync(
      hist, 0, sizeof(unsigned) * SORT_RADIX * plan.passes, s);
  if (err != cudaSuccess) return err;
  weld_sort_histogram_kernel<K><<<(unsigned)((n + HIST_KEYS - 1) / HIST_KEYS),
                                  SORT_THREADS, 0, s>>>(
      keys, n, plan, hist, state, plan.passes * pass_words + extra_words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const void* in_keys = keys;
  const int* in_idx = nullptr;
  for (int p = 0; p < plan.passes; ++p) {
    K* out_keys = reinterpret_cast<K*>(work + ((plan.passes - 1 - p) % 2) *
                                                  buffer);
    int* out_idx = reinterpret_cast<int*>(out_keys + n);
    const bool grouped = sort_grouped(tiles);
    auto kernel = p == 0 ? (grouped ? weld_sort_pass_kernel<K, true, true>
                                    : weld_sort_pass_kernel<K, true, false>)
                         : (grouped ? weld_sort_pass_kernel<K, false, true>
                                    : weld_sort_pass_kernel<K, false, false>);
    kernel<<<tiles, SORT_THREADS, 0, s>>>(in_keys, in_idx, n, plan, p, hist,
                                          state + p * pass_words, out_keys,
                                          out_idx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    in_keys = out_keys;
    in_idx = out_idx;
  }
  return cudaSuccess;
}

// --- the group kernel --------------------------------------------------

// What a key tells the group kernel: its group (the top bits), and its
// local word (the free bits under the external flag, the key's top bit,
// which is among the top bits: a group's keys share it).
struct WeldShape {
  int key_bits, free_bits, capacity, digits, width;
};

template <typename K>
__device__ __forceinline__ K weld_top(K key, const WeldShape& w) {
  return key >> w.free_bits;
}

template <typename K>
__device__ __forceinline__ unsigned weld_word(K key, const WeldShape& w) {
  const unsigned ext = (unsigned)(key >> (w.key_bits - 1)) & 1u;
  const K free_mask = ((K)1 << w.free_bits) - (K)1;
  return (unsigned)(key & free_mask) | (ext ? EXT_WORD : 0u);
}

// One local digit of a group's stable sort by a warp: the group's slots
// [s, e) of `src` into the same slots of `dst`, by digit `digit` of the
// local words. The warp counts the digit's values in its histogram (equal
// digits of 32 slots added once, by their first lane), takes their
// exclusive prefix, then ranks the slots 32 at a time again: a slot goes
// after every slot of the group of lower digit and every slot before it
// of its digit, so equal words keep their order.
__device__ __forceinline__ void weld_local_digit(
    const unsigned* __restrict__ src_w, const unsigned* __restrict__ src_i,
    unsigned* __restrict__ dst_w, unsigned* __restrict__ dst_i, int s,
    int e, int digit, const WeldShape& w, unsigned* hist) {
  const int lane = threadIdx.x & 31;
  const unsigned below_me = (1u << lane) - 1u;
  const int left = w.free_bits - digit * w.width;
  const int bins = 1 << (left < w.width ? left : w.width);
  for (int b = lane; b < bins; b += 32) hist[b] = 0u;
  __syncwarp();
  for (int c = s; c < e; c += 32) {
    const int q = c + lane;
    const bool valid = q < e;
    const unsigned d = valid ? mesh_weld_local_digit(src_w[q], digit,
                                                     w.width, w.free_bits)
                             : 0u;
    const unsigned peers = sort_match_digit(d, valid);
    if (valid && (peers & below_me) == 0u) hist[d] += (unsigned)__popc(peers);
    __syncwarp();
  }
  // the exclusive prefix, a run of bins a lane
  const int per = bins < 32 ? 1 : bins / 32;
  const int b0 = lane * per;
  unsigned sum = 0u;
  for (int b = b0; b < b0 + per && b < bins; ++b) sum += hist[b];
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += v;
  }
  unsigned run = incl - sum;
  for (int b = b0; b < b0 + per && b < bins; ++b) {
    const unsigned c = hist[b];
    hist[b] = run;
    run += c;
  }
  __syncwarp();
  for (int c = s; c < e; c += 32) {
    const int q = c + lane;
    const bool valid = q < e;
    const unsigned word = valid ? src_w[q] : 0u;
    const unsigned idx = valid ? src_i[q] : 0u;
    const unsigned d =
        mesh_weld_local_digit(word, digit, w.width, w.free_bits);
    const unsigned peers = sort_match_digit(d, valid);
    const unsigned before = (unsigned)__popc(peers & below_me);
    const unsigned at = valid ? hist[d] : 0u;
    __syncwarp();
    if (valid && before == 0u) hist[d] = at + (unsigned)__popc(peers);
    __syncwarp();
    if (valid) {
      dst_w[s + at + before] = word;
      dst_i[s + at + before] = idx;
    }
  }
  __syncwarp();
}

// The slots from `first`, a lane each, ranked by a warp at once within
// their groups: `group` is the lanes of this lane's group (it holds them
// all); a slot's rank is the group's slots of lower free bits and those
// before it of equal ones, by a ballot a free bit from the highest (the
// lanes of the group still equal above it). Lanes in `mine` write their
// slot into `dst` (which may be `src`) at the group's first slot plus the
// rank.
__device__ __forceinline__ void weld_warp_rank(
    const unsigned* src_w, const unsigned* src_i, unsigned* dst_w,
    unsigned* dst_i, int first, unsigned group, bool mine,
    const WeldShape& w) {
  const int lane = threadIdx.x & 31;
  const unsigned word = mine ? src_w[first + lane] : 0u;
  const unsigned idx = mine ? src_i[first + lane] : 0u;
  unsigned equal = group, less = 0u;
  for (int b = w.free_bits - 1; b >= 0; --b) {
    const bool one = (word >> b) & 1u;
    const unsigned ones = __ballot_sync(0xFFFFFFFFu, mine && one);
    if (one) {
      less += (unsigned)__popc(equal & ~ones);
      equal &= ones;
    } else {
      equal &= ~ones;
    }
  }
  const int at = first + (__ffs(group) - 1) + (int)less +
                 __popc(equal & ((1u << lane) - 1u));
  __syncwarp();
  if (mine) {
    dst_w[at] = word;
    dst_i[at] = idx;
  }
  __syncwarp();
}

// Whether slot q of the finished range starts a run of equal keys: a group
// starts there, or its word differs from the one before.
__device__ __forceinline__ bool weld_run_start(const unsigned* words,
                                               const unsigned* start_bits,
                                               int q) {
  const bool group = q < G_TILE && ((start_bits[q >> 5] >> (q & 31)) & 1u);
  return group || words[q] != words[q - 1];
}

// A round's marks: thread t's MESH_WELD_ITEMS consecutive slots from
// `first`, below `end`: which start a run (bit i), and which of those
// are internal.
__device__ __forceinline__ void weld_marks(const unsigned* words,
                                           const unsigned* start_bits,
                                           int first, int end,
                                           unsigned* starts,
                                           unsigned* internal) {
  *starts = 0u;
  *internal = 0u;
#pragma unroll
  for (int i = 0; i < G_ITEMS; ++i) {
    const int q = first + i;
    if (q < end && weld_run_start(words, start_bits, q)) {
      *starts |= 1u << i;
      if ((words[q] & EXT_WORD) == 0u) *internal |= 1u << i;
    }
  }
}

// Window j (slots [32 j, 32 j + 32)) of the range [lo, hi): whether this
// lane's slot lies in a group inside the window, and that group's lanes.
__device__ __forceinline__ bool weld_window_group(const unsigned* start_bits,
                                                  int lo, int hi, int j,
                                                  unsigned* group) {
  const int lane = threadIdx.x & 31;
  const int q = 32 * j + lane;
  const unsigned sw = j < G_TILE / 32 ? start_bits[j] : 0u;
  const unsigned next = j + 1 < G_TILE / 32 ? start_bits[j + 1] & 1u : 0u;
  const unsigned below = (2u << lane) - 1u;   // lanes 0..lane
  const unsigned upto = sw & below, above = sw & ~below;
  const int gs = upto ? 31 - __clz(upto) : -1;
  const int ge = above ? __ffs(above) - 1
                 : hi <= 32 * j + 32 ? hi - 32 * j
                 : next ? 32 : 33;
  const bool inside = q >= lo && q < hi && gs >= 0 && ge <= 32;
  *group = inside ? (ge == 32 ? 0xFFFFFFFFu : (1u << ge) - 1u) &
                        ~((1u << gs) - 1u)
                  : 0u;
  return inside;
}

// A ticketed tile of G_TILE positions of the top-sorted keys `keys` and
// their indices: the CTA's range is [lo, hi), from the first group that
// starts in the tile to the end of the last one, its slots the positions
// from the tile's first. A group longer than w.capacity is counted (the
// third count) and nothing of the CTA's range is written.
template <typename K>
__global__ void __launch_bounds__(G_THREADS)
weld_group_kernel(const K* __restrict__ keys, const int* __restrict__ idx_in,
                  int n, const __grid_constant__ WeldShape w,
                  const float* __restrict__ vertices,
                  const unsigned* __restrict__ key_hi,
                  const unsigned* __restrict__ key_lo,
                  unsigned long long* state, float* __restrict__ out_vertices,
                  unsigned* __restrict__ out_hi,
                  unsigned* __restrict__ out_lo, int* __restrict__ remap,
                  long long* __restrict__ totals) {
  extern __shared__ __align__(16) unsigned char weld_smem[];
  const int slots = G_TILE + w.capacity;
  unsigned* const word_a = reinterpret_cast<unsigned*>(weld_smem);
  unsigned* const idx_a = word_a + slots;
  unsigned* const word_b = idx_a + slots;
  unsigned* const idx_b = word_b + slots;
  unsigned short* const group_at =
      reinterpret_cast<unsigned short*>(idx_b + slots);
  unsigned short* const cross = group_at + G_TILE + 2;
  __shared__ unsigned start_bits[G_TILE / 32];
  __shared__ unsigned hist[G_WARPS][G_BINS];
  __shared__ unsigned scan_shared[MESH_WELD_COUNTS * 33];
  __shared__ unsigned long long base[MESH_WELD_COUNTS];
  __shared__ K last_top;
  __shared__ int groups, crossing, overflow;
  const int tile = scan_ticket(state);
  unsigned long long* const status = state + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t0 = (long long)tile * G_TILE;
  const int tile_n = (int)min((long long)G_TILE, (long long)n - t0);

  // the tile, coalesced: each slot's word and index, and which slots
  // start a group (bit q of start_bits), every load in flight together
  K key[G_LOAD];
  int idx[G_LOAD];
#pragma unroll
  for (int i = 0; i < G_LOAD; ++i) {
    const int q = i * G_THREADS + threadIdx.x;
    key[i] = q < tile_n ? __ldg(&keys[t0 + q]) : (K)0;
    idx[i] = q < tile_n ? __ldg(&idx_in[t0 + q]) : 0;
  }
  if (threadIdx.x == 0) {
    crossing = 0;
    overflow = 0;
  }
#pragma unroll
  for (int i = 0; i < G_LOAD; ++i) {
    const int q = i * G_THREADS + threadIdx.x;
    // the key before the slot: the lane before's, or for lane 0 the key
    // before the warp's first (the previous warp's line, in cache)
    K prev = __shfl_up_sync(0xFFFFFFFFu, key[i], 1);
    if (lane == 0) {
      const long long p = t0 + q - 1;
      prev = p >= 0 && p < n ? __ldg(&keys[p]) : (K)0;
    }
    const bool starts =
        q < tile_n &&
        (t0 + q == 0 || weld_top(key[i], w) != weld_top(prev, w));
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, starts);
    if (lane == 0) start_bits[q >> 5] = bits;
    if (q < tile_n) {
      word_a[q] = weld_word(key[i], w);
      idx_a[q] = (unsigned)idx[i];
    }
    if (q == tile_n - 1) last_top = weld_top(key[i], w);
  }
  __syncthreads();
  // the groups' starts in slot order (warp 0, G_WORDS start words a lane)
  if (warp == 0) {
    unsigned c = 0u;
#pragma unroll
    for (int i = 0; i < G_WORDS; ++i)
      c += (unsigned)__popc(start_bits[G_WORDS * lane + i]);
    unsigned incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += v;
    }
    unsigned at = incl - c;
#pragma unroll
    for (int i = 0; i < G_WORDS; ++i) {
      const int word = G_WORDS * lane + i;
      for (unsigned m = start_bits[word]; m != 0u; m &= m - 1u)
        group_at[at++] = (unsigned short)(32 * word + __ffs(m) - 1);
    }
    if (lane == 31) groups = (int)incl;
  }
  __syncthreads();
  const int ngroups = groups;
  int lo = 0, hi = 0;
  if (ngroups > 0) {
    lo = group_at[0];
    hi = tile_n;
    // the last group's overhang past the tile, G_OVER chunks of a slot a
    // thread at a time (their loads in flight together), to its end or to
    // one slot past the capacity (then it overflows)
    if (t0 + tile_n < n) {
      const int last = group_at[ngroups - 1];
      const int limit = last + w.capacity + 1;
      const K top = last_top;
      bool open = true;
      for (int c = G_TILE; open; c += G_OVER * G_THREADS) {
        K k[G_OVER];
        unsigned ix[G_OVER];
#pragma unroll
        for (int i = 0; i < G_OVER; ++i) {
          const int q = c + i * G_THREADS + threadIdx.x;
          const bool in = t0 + q < n && q < limit;
          k[i] = in ? __ldg(&keys[t0 + q]) : (K)0;
          ix[i] = in ? (unsigned)__ldg(&idx_in[t0 + q]) : 0u;
        }
#pragma unroll
        for (int i = 0; i < G_OVER; ++i) {
          const int q = c + i * G_THREADS + threadIdx.x;
          const bool same =
              t0 + q < n && q < limit && weld_top(k[i], w) == top;
          if (same) {
            word_a[q] = weld_word(k[i], w);
            idx_a[q] = ix[i];
          }
          const int count = __syncthreads_count(same);
          if (count < G_THREADS && open) {
            hi = c + i * G_THREADS + count;
            open = false;
          }
        }
      }
    }
  }
  // a group past the capacity; the groups that cross a window's edge
  for (int k = threadIdx.x; k < ngroups; k += G_THREADS) {
    const int gs = group_at[k];
    const int ge = k + 1 < ngroups ? group_at[k + 1] : hi;
    if (ge - gs > w.capacity) overflow = 1;
    if ((gs >> 5) != ((ge - 1) >> 5))
      cross[atomicAdd(&crossing, 1)] = (unsigned short)k;
  }
  __syncthreads();
  const bool active = ngroups > 0 && overflow == 0;

  // the groups' sort by their free bits into the final buffer (the first
  // with an even count of local digits, else the second). Every group
  // inside one window of 32 slots (a start word) is ranked with the others
  // of its window at once, a warp a window; a group that crosses a
  // window's edge is listed, and a warp a listed group ranks it at once
  // where it has at most 32 slots, else sorts it a local digit at a time.
  unsigned* const final_w = (w.digits & 1) ? word_b : word_a;
  unsigned* const final_i = (w.digits & 1) ? idx_b : idx_a;
  if (active && w.digits > 0) {
    for (int j = (lo >> 5) + warp; j <= (hi - 1) >> 5; j += G_WARPS) {
      unsigned group;
      const bool inside = weld_window_group(start_bits, lo, hi, j, &group);
      weld_warp_rank(word_a, idx_a, final_w, final_i, 32 * j, group, inside,
                     w);
    }
    for (int c = warp; c < crossing; c += G_WARPS) {
      const int k = cross[c];
      const int gs = group_at[k];
      const int ge = k + 1 < ngroups ? group_at[k + 1] : hi;
      if (ge - gs <= 32) {
        const unsigned group =
            ge - gs == 32 ? 0xFFFFFFFFu : (1u << (ge - gs)) - 1u;
        weld_warp_rank(word_a, idx_a, final_w, final_i, gs, group,
                       lane < ge - gs, w);
        continue;
      }
      for (int d = 0; d < w.digits; ++d) {
        const bool even = (d & 1) == 0;
        weld_local_digit(even ? word_a : word_b, even ? idx_a : idx_b,
                         even ? word_b : word_a, even ? idx_b : idx_a, gs,
                         ge, d, w, hist[warp]);
      }
    }
  }
  __syncthreads();
  const unsigned* const words = final_w;
  const unsigned* const order = final_i;
  // the other buffer, free now: a run's first slot (run_slot) and a
  // slot's run (slot_run), runs numbered from 0 in the range
  unsigned* const run_slot = (w.digits & 1) ? word_a : word_b;
  unsigned* const slot_run = (w.digits & 1) ? idx_a : idx_b;

  // the range's runs, a round of G_ITEMS consecutive slots a thread at a
  // time: which slots start one, and of those which are internal (scanned
  // across the CTA), each run's first slot and each slot's run
  unsigned runs = 0u, internal_runs = 0u;
  for (int r = lo; active && r < hi; r += G_ROUND) {
    const int first = r + (int)threadIdx.x * G_ITEMS;
    unsigned starts, internal, at[2], total[2];
    weld_marks(words, start_bits, first, hi, &starts, &internal);
    const unsigned v[2] = {(unsigned)__popc(starts),
                           (unsigned)__popc(internal)};
    scan_cta<2>(v, at, total, scan_shared);
    unsigned run = runs + at[0] - 1u;
#pragma unroll
    for (int i = 0; i < G_ITEMS; ++i) {
      if (first + i < hi) {
        if ((starts >> i) & 1u) run_slot[++run] = (unsigned)(first + i);
        slot_run[first + i] = run;
      }
    }
    runs += total[0];
    internal_runs += total[1];
  }
  // the tile's aggregates, published as soon as they are known
  unsigned long long* const my_word =
      status + (long long)tile * MESH_WELD_COUNTS + warp;
  const unsigned long long mine =
      warp == 0 ? runs : warp == 1 ? internal_runs : (unsigned)overflow;
  if (warp < MESH_WELD_COUNTS && lane == 0)
    scan_publish(my_word, tile == 0 ? SCAN_INCLUSIVE : SCAN_AGGREGATE, mine);
  __syncthreads();
  // the representatives' positions and key halves, a run a thread
  // (G_REPS a thread in registers, loaded before the look-back)
  float pos[G_REPS][3];
  unsigned rep_hi[G_REPS], rep_lo[G_REPS];
#pragma unroll
  for (int k = 0; k < G_REPS; ++k) {
    const unsigned r = threadIdx.x + k * G_THREADS;
    if (r < runs) {
      const long long v = order[run_slot[r]];
      pos[k][0] = __ldg(&vertices[3 * v]);
      pos[k][1] = __ldg(&vertices[3 * v + 1]);
      pos[k][2] = __ldg(&vertices[3 * v + 2]);
      rep_hi[k] = __ldg(&key_hi[v]);
      rep_lo[k] = __ldg(&key_lo[v]);
    }
  }
  // warp k looks back for count k
  if (warp < MESH_WELD_COUNTS) {
    const unsigned long long excl =
        tile == 0 ? 0ULL
                  : scan_lookback_warp(status + warp, MESH_WELD_COUNTS, tile);
    if (lane == 0) {
      if (tile > 0) scan_publish(my_word, SCAN_INCLUSIVE, excl + mine);
      base[warp] = excl;
      if (tile == (int)gridDim.x - 1)
        totals[warp] = (long long)(excl + mine);
    }
  }
  __syncthreads();
  if (!active) return;
  const long long first_id = (long long)base[0];
  // the welded vertices, consecutive threads to consecutive ones
#pragma unroll
  for (int k = 0; k < G_REPS; ++k) {
    const unsigned r = threadIdx.x + k * G_THREADS;
    if (r < runs) {
      const long long id = first_id + r;
      out_vertices[3 * id] = pos[k][0];
      out_vertices[3 * id + 1] = pos[k][1];
      out_vertices[3 * id + 2] = pos[k][2];
      out_hi[id] = rep_hi[k];
      out_lo[id] = rep_lo[k];
    }
  }
  for (unsigned r = threadIdx.x + G_REPS * G_THREADS; r < runs;
       r += G_THREADS) {
    const long long v = order[run_slot[r]], id = first_id + r;
    out_vertices[3 * id] = __ldg(&vertices[3 * v]);
    out_vertices[3 * id + 1] = __ldg(&vertices[3 * v + 1]);
    out_vertices[3 * id + 2] = __ldg(&vertices[3 * v + 2]);
    out_hi[id] = __ldg(&key_hi[v]);
    out_lo[id] = __ldg(&key_lo[v]);
  }
  // the remap of every slot
  for (int q = lo + (int)threadIdx.x; q < hi; q += G_THREADS)
    remap[order[q]] = (int)(first_id + slot_run[q]);
}

// --- the pack ----------------------------------------------------------

struct PackFrame {
  long long org2[3];       // 2 cell_origin
  int mode;                // MESH_INDEX_*
  int vertex_words;        // 3 or 4
  long long index_words;   // the index region's words
};

// Threads [0, nw): welded vertex i's words into the vertex region;
// threads [nw, nw + nt): triangle t's remapped indices, as the mode's
// index words (MESH_INDEX_RAW: three int32 into `out`, nw = 0). Thread 0
// also zeroes the pad halfwords: the index region's after an odd count of
// u16 indices, the vertex region's after an odd count of vertex words.
__global__ void __launch_bounds__(THREADS)
pack_readback_kernel(const float* __restrict__ vertices,
                     const unsigned* __restrict__ key_hi,
                     const unsigned* __restrict__ key_lo, long long nw,
                     const int* __restrict__ triangles,
                     const int* __restrict__ remap, long long nt,
                     const __grid_constant__ PackFrame f,
                     int* __restrict__ out) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  unsigned short* half = reinterpret_cast<unsigned short*>(out);
  unsigned short* vertex_half = half + 2 * f.index_words;
  if (i == 0 && f.mode != MESH_INDEX_RAW) {
    if (f.mode == MESH_INDEX_U16 && (3 * nt) % 2 == 1) half[3 * nt] = 0;
    if ((nw * f.vertex_words) % 2 == 1) vertex_half[nw * f.vertex_words] = 0;
  }
  if (i < nw) {
    const float v[3] = {__ldg(&vertices[3 * i]), __ldg(&vertices[3 * i + 1]),
                        __ldg(&vertices[3 * i + 2])};
    unsigned short w[4];
    mesh_vertex_words(v, __ldg(&key_hi[i]), __ldg(&key_lo[i]), f.org2,
                      f.vertex_words, w);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < f.vertex_words) vertex_half[i * f.vertex_words + k] = w[k];
    return;
  }
  const long long t = i - nw;
  if (t >= nt) return;
  int idx[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) idx[m] = __ldg(&remap[__ldg(&triangles[3 * t + m])]);
  if (f.mode == MESH_INDEX_U16) {
#pragma unroll
    for (int m = 0; m < 3; ++m)
      half[3 * t + m] = (unsigned short)(idx[m] & 0xFFFF);
  } else if (f.mode == MESH_INDEX_U21X3) {
    unsigned w0, w1;
    mesh_u21x3(idx[0], idx[1], idx[2], &w0, &w1);
    out[2 * t] = (int)w0;
    out[2 * t + 1] = (int)w1;
  } else {
#pragma unroll
    for (int m = 0; m < 3; ++m) out[3 * t + m] = idx[m];
  }
}

// The group kernel's dynamic shared memory allowed up to what the largest
// capacity needs, once a device (a launch past it is refused, and
// weld_launch returns that error).
template <typename K>
cudaError_t weld_group_allow() {
  static std::atomic<bool> allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && allowed[dev].load())) return err;
  err = cudaFuncSetAttribute(
      weld_group_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mesh_weld_shared_bytes(MESH_WELD_MAX_CAPACITY));
  if (err == cudaSuccess && dev < 64) allowed[dev].store(true);
  return err;
}

unsigned int blocks_for(long long items) {
  return (unsigned int)((items + THREADS - 1) / THREADS);
}

}  // namespace

// weld_launch: the weld of n unwelded vertices (0 < n < 2^31) by their
// compact sort keys of key_bits bits (the external flag the top one; 4
// bytes each up to 32 bits, else 8: mesh_sort_key_bytes): the
// sort's global passes over the top digits (mesh_sort_passes) into
// `work`, then the group kernel at the plan's capacity
// (mesh_weld_group_bound of the free bits): the welded vertices (3 floats
// each) and key halves in out_vertices, out_hi, out_lo (n each, the first
// `welded` live), the remap of every unwelded vertex (n int32), and
// `totals` (welded vertices, first external, groups past the capacity;
// int64: the weld is valid only where the last is 0). `work`:
// mesh_weld_work_words int32 words, `scratch`: mesh_weld_scratch_words
// 64-bit words (mesh.cuh).
extern "C" int weld_launch(const void* sort_keys, long long n,
                           int key_bits, const float* vertices,
                           const unsigned* key_hi, const unsigned* key_lo,
                           int* work, unsigned long long* scratch,
                           float* out_vertices, unsigned* out_hi,
                           unsigned* out_lo, int* remap, long long* totals,
                           void* stream) {
  if (n <= 0 || n >= (1LL << 31) || key_bits < 2 || key_bits > 64 ||
      work == nullptr)
    return (int)cudaErrorInvalidValue;
  const int passes = mesh_sort_passes(key_bits);
  const int free_bits = mesh_weld_free_bits(key_bits, passes);
  const int capacity = (int)mesh_weld_group_bound(key_bits, free_bits);
  if (passes > SORT_MAX_PASSES || free_bits > MESH_WELD_MAX_FREE_BITS)
    return (int)cudaErrorInvalidValue;
  const SortPlan plan = mesh_weld_sort_plan(key_bits, passes);
  const int kb = mesh_sort_key_bytes(key_bits);
  const cudaStream_t s = (cudaStream_t)stream;
  const long long buffer = mesh_weld_buffer_words(n, key_bits);
  const long long state_words = mesh_weld_state_words(n);
  unsigned long long* group_state =
      scratch + sort_scratch_words(n, passes, kb);
  cudaError_t err =
      kb == 4 ? weld_sort<unsigned>(static_cast<const unsigned*>(sort_keys),
                                    (int)n, plan, work, buffer, scratch,
                                    state_words, s)
              : weld_sort<unsigned long long>(
                    static_cast<const unsigned long long*>(sort_keys), (int)n,
                    plan, work, buffer, scratch, state_words, s);
  if (err != cudaSuccess) return (int)err;
  const WeldShape shape{key_bits, free_bits, capacity,
                        mesh_weld_local_digits(free_bits),
                        mesh_weld_local_width(free_bits)};
  const int bytes = (int)mesh_weld_shared_bytes(capacity);
  const unsigned grid = (unsigned)((n + G_TILE - 1) / G_TILE);
  const int* idx = work + (kb / 4) * n;   // the last pass's, in buffer 0
  if (kb == 4) {
    err = weld_group_allow<unsigned>();
    if (err != cudaSuccess) return (int)err;
    weld_group_kernel<unsigned><<<grid, G_THREADS, bytes, s>>>(
        reinterpret_cast<const unsigned*>(work), idx, (int)n, shape,
        vertices, key_hi, key_lo, group_state, out_vertices, out_hi, out_lo,
        remap, totals);
  } else {
    err = weld_group_allow<unsigned long long>();
    if (err != cudaSuccess) return (int)err;
    weld_group_kernel<unsigned long long><<<grid, G_THREADS, bytes, s>>>(
        reinterpret_cast<const unsigned long long*>(work), idx, (int)n,
        shape, vertices, key_hi, key_lo, group_state, out_vertices, out_hi,
        out_lo, remap, totals);
  }
  return (int)cudaGetLastError();
}

// pack_readback_launch: the packed image of a welded mesh (nw vertices
// and key halves, nt unwelded triangles and the remap), in index mode
// `mode` (MESH_INDEX_U16, _U21X3, _U32) with `vertex_words` (3 or 4) u16
// words a vertex, a cell origin (ox, oy, oz), into `out` of
// PackFormat.total_words int32 words; or, mode
// MESH_INDEX_RAW, the remapped triangles alone into `out` (3 nt int32).
// Nothing to write launches nothing.
extern "C" int pack_readback_launch(const float* vertices,
                                    const unsigned* key_hi,
                                    const unsigned* key_lo, long long nw,
                                    const int* triangles, const int* remap,
                                    long long nt, long long ox, long long oy,
                                    long long oz, int mode, int vertex_words,
                                    int* out, void* stream) {
  if (nw < 0 || nt < 0 || mode < MESH_INDEX_U16 || mode > MESH_INDEX_RAW ||
      (mode != MESH_INDEX_RAW && vertex_words != 3 && vertex_words != 4))
    return (int)cudaErrorInvalidValue;
  if (mode == MESH_INDEX_RAW) nw = 0;
  if (nw + nt == 0) return (int)cudaSuccess;
  const PackFrame f{{2 * ox, 2 * oy, 2 * oz}, mode, vertex_words,
                    mode == MESH_INDEX_RAW ? 0 : mesh_index_words(mode, 3 * nt)};
  pack_readback_kernel<<<blocks_for(nw + nt), THREADS, 0,
                         (cudaStream_t)stream>>>(vertices, key_hi, key_lo, nw,
                                                 triangles, remap, nt, f, out);
  return (int)cudaGetLastError();
}
