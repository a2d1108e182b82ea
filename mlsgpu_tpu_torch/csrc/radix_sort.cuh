// A stable LSD radix sort of integer keys with their permutation, in
// digits of at most SORT_DIGIT_BITS bits: a histogram kernel that counts
// every pass's digits (and clears the passes' scan state), then a kernel a
// pass on a look-back scan of scan.cuh. The kernels' bodies live
// here as device functions so that two stages share them: binning's sort
// of the node keys (binning.cu: bin_sort_histogram_kernel,
// bin_sort_pass_kernel, 32-bit keys between passes) and the weld's sort of
// the compact vertex keys (mesh.cu: weld_sort_histogram_kernel,
// weld_sort_pass_kernel, 32- or 64-bit keys between passes by the keys'
// bit length). Each stage's kernels are thin __global__ wrappers, so its
// kernels keep names of their own in a profiler trace.
//
// A sort reads its input keys (In: int64 by default; the weld reads its
// keys at their sort width) and maps each to its sort key (Map::in), keeps
// the sort keys (K, unsigned or unsigned long long) and int32 indices
// between passes, and writes int64 keys (mapped back, Map::out) and the
// int64 permutation: equal keys keep their input order, so the result is
// torch.sort(stable=True)'s bit for bit whatever the CTAs' timing (the
// counts are integers, and each key's place follows from the counts and
// the order of the items alone: sort_pass_body).
//
// What bounds a pass on the H100: not its bytes (8-24 a key, 1.6-4.8 us
// at 256^3) but one CTA's chain of dependent steps, since at a block's
// sizes every tile runs in one wave or a few (a clock64 probe of the
// design before this one, a decoupled look-back for every pass: a CTA
// 8.5-9.5 us at 256^3; the ticket 0.5 and then the keys' loads 0.8-1.6,
// the look-back over the wave 2.3-2.7; the latest tiles,
// whose look-backs walk furthest, ending ~3 us after the first). So a
// pass loads its keys while it takes its ticket, and a pass of about one
// wave looks back on two levels (scan.cuh); a pass of many waves keeps the
// decoupled look-back, whose later waves find inclusive prefixes at once
// and which leaves more CTAs an SM. A ranking with no warp barrier between
// items (each run's first lane taking its places by an atomic add and
// handing them on by a shuffle, after a counting sweep that published the
// counts before the ranking) measured slower and was taken out.
//
// The plan and the scratch sizes are plain host-compilable code, so the
// g++ host builds of the tests check them.

#pragma once

#include "scan.cuh"

#if defined(__CUDACC__)
#define SORT_FN __host__ __device__ __forceinline__
#else
#define SORT_FN static inline
#endif

#define SORT_DIGIT_BITS 8
#define SORT_RADIX (1 << SORT_DIGIT_BITS)
// 43 bits (the weld's keys at 2^13 corners an axis) take 6 passes.
#define SORT_MAX_PASSES 6
// A CTA of SORT_THREADS threads (a thread a digit) ranks a tile of keys,
// sort_items(key bytes) a thread: 16 32-bit keys, or 8 64-bit keys (the
// tile staged in shared memory stays under the 48 KB of static shared
// memory).
#define SORT_THREADS 256
// The histogram kernel's keys a thread: half a 32-bit pass tile a CTA.
#define SORT_HIST_ITEMS 8

// A sort's digits: bits [shift[p], shift[p] + bits[p]) in pass p, from the
// lowest bit, SORT_DIGIT_BITS a pass (the last takes what is left). `top`
// is the map's parameter (binning: the sort key of BIN_INVALID_KEY).
struct SortPlan {
  unsigned top;
  int passes;
  int shift[SORT_MAX_PASSES];
  int bits[SORT_MAX_PASSES];
};

static inline SortPlan sort_plan(int key_bits, unsigned top) {
  SortPlan plan{top, 0, {}, {}};
  for (int s = 0; s < key_bits; s += SORT_DIGIT_BITS, ++plan.passes) {
    plan.shift[plan.passes] = s;
    plan.bits[plan.passes] =
        key_bits - s < SORT_DIGIT_BITS ? key_bits - s : SORT_DIGIT_BITS;
  }
  return plan;
}

template <typename K>
SORT_FN unsigned sort_digit(K m, int shift, int bits) {
  return (unsigned)(m >> shift) & ((1u << bits) - 1u);
}

// Keys a thread and a tile of a pass with `key_bytes`-byte sort keys.
SORT_FN constexpr int sort_items(int key_bytes) { return key_bytes == 8 ? 8 : 16; }
SORT_FN constexpr int sort_tile_keys(int key_bytes) {
  return SORT_THREADS * sort_items(key_bytes);
}

// A pass of at most SORT_GROUPED_TILES tiles runs in about one wave of
// CTAs (two a 132-SM H100's SM: the sort's 162-190 tiles at 256^3) and
// takes the two-level look-back (scan.cuh); a larger one, whose later
// waves find their lower tiles' inclusive prefixes at once, the decoupled
// look-back, with fewer registers and so more CTAs an SM (sort_pass_body).
#define SORT_GROUPED_TILES 256

// The tiles of n keys, and the 64-bit words of a sort's scratch: the
// passes' histograms (SORT_RADIX 32-bit counts each, two a word), then for
// each pass its ticket and its look-back's words (scan.cuh): a 64-bit
// status word a (tile, digit), or, for the two-level look-back, 32-bit
// words (two a 64-bit word) a (tile, digit) and two a (group of
// SCAN_GROUP tiles, digit).
static inline long long sort_tiles(long long n, int key_bytes) {
  return (n + sort_tile_keys(key_bytes) - 1) / sort_tile_keys(key_bytes);
}

SORT_FN bool sort_grouped(long long tiles) {
  return tiles <= SORT_GROUPED_TILES;
}

static inline long long sort_pass_words(long long n, int key_bytes) {
  const long long tiles = sort_tiles(n, key_bytes);
  const long long groups = (tiles + SCAN_GROUP - 1) / SCAN_GROUP;
  return 1 + (sort_grouped(tiles) ? (tiles + 2 * groups) * (SORT_RADIX / 2)
                                  : tiles * SORT_RADIX);
}

static inline long long sort_scratch_words(long long n, int passes,
                                           int key_bytes) {
  return (long long)passes *
         (SORT_RADIX / 2 + sort_pass_words(n, key_bytes));
}

#if defined(__CUDACC__)

// The identity map: the int64 keys are the sort keys.
template <typename K>
struct SortIdentity {
  static __device__ __forceinline__ K in(long long key, unsigned) {
    return (K)key;
  }
  static __device__ __forceinline__ long long out(K m, unsigned) {
    return (long long)m;
  }
};

// The lanes of the warp whose digit equals this lane's (invalid lanes
// match each other only): one match.any, where a ballot a bit of the
// digit took the sort 1.4x as long on the H100.
__device__ __forceinline__ unsigned sort_match_digit(unsigned d, bool valid) {
  return __match_any_sync(0xFFFFFFFFu, valid ? d : 0xFFFFFFFFu);
}

// Every pass's digit counts of the n keys into hist (passes x SORT_RADIX,
// zero before), a CTA SORT_THREADS * SORT_HIST_ITEMS keys: counts in
// shared memory (a warp's equal digits added once, by their first lane),
// then one global add a digit. It also clears `state_words` words of
// scan state (`state`: the passes' tickets and look-back words, and whatever
// later kernel of the stage asked for it): it runs just before them on
// the stream.
template <typename K, typename Map, typename In = long long>
__device__ __forceinline__ void sort_histogram_body(
    const In* __restrict__ keys, int n, const SortPlan& plan,
    unsigned* __restrict__ hist, unsigned long long* __restrict__ state,
    long long state_words) {
  __shared__ unsigned counts[SORT_MAX_PASSES][SORT_RADIX];
  constexpr int HIST_KEYS = SORT_THREADS * SORT_HIST_ITEMS;
  for (long long i = blockIdx.x * (long long)SORT_THREADS + threadIdx.x;
       i < state_words; i += (long long)gridDim.x * SORT_THREADS)
    state[i] = 0ULL;
  for (int p = 0; p < plan.passes; ++p) counts[p][threadIdx.x] = 0u;
  // the CTA's keys, all loads in flight together
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * HIST_KEYS + threadIdx.x;
  K m[SORT_HIST_ITEMS];
#pragma unroll
  for (int i = 0; i < SORT_HIST_ITEMS; ++i) {
    const long long e = first + i * SORT_THREADS;
    m[i] = e < n ? Map::in(__ldg(&keys[e]), plan.top) : (K)0;
  }
  __syncthreads();
  for (int p = 0; p < plan.passes; ++p) {
#pragma unroll
    for (int i = 0; i < SORT_HIST_ITEMS; ++i) {
      const bool valid = first + i * SORT_THREADS < n;
      const unsigned d = sort_digit(m[i], plan.shift[p], plan.bits[p]);
      const unsigned peers = sort_match_digit(d, valid);
      if (valid && lane == __ffs(peers) - 1)
        atomicAdd(&counts[p][d], (unsigned)__popc(peers));
    }
  }
  __syncthreads();
  for (int p = 0; p < plan.passes; ++p) {
    const unsigned c = counts[p][threadIdx.x];
    if (c != 0u) atomicAdd(&hist[p * SORT_RADIX + threadIdx.x], c);
  }
}

// One pass of the sort: the keys stably by digit `pass`, a CTA a tile of
// SORT_THREADS * ITEMS keys taken by ticket (scan.cuh). Warp w holds the
// keys [w * 32 * ITEMS, (w + 1) * 32 * ITEMS) of the tile, item i of lane
// l the key 32 i + l of them, so a warp's items in item order are its keys
// in order. The keys of tile blockIdx.x, the ticket a CTA mostly takes,
// are loaded while it takes its ticket, and reloaded where the ticket
// differs. It ranks them item by item (the lanes of equal digit by
// match.any, counted per warp in shared memory), so a key's rank in the
// tile is the tile's keys of lower digit, those of its digit in lower
// warps, and those before it in its warp: stable from the items' order
// alone. Thread d then publishes the tile's count of digit d and finds the
// count of digit d in the lower tiles: GROUPED (sort_grouped), by the
// two-level look-back, a group's first tile over the groups below before
// it stages its keys (publishing the group's prefix), any other tile after
// (from that prefix and its group's lower tiles' counts, one round); else
// by the decoupled look-back (scan_lookback). With the digit's base from
// the histogram, that is where the tile's keys of digit d start in the
// output. The tile is staged in shared memory in digit order and written
// out from there, consecutive threads to consecutive places. FIRST: the
// int64 keys in (Map::in), their index e the entry; else the K keys and
// int32 indices of the pass before. LAST: the int64 keys (Map::out) and
// the int64 permutation out; else K keys and int32 indices for the next
// pass. In: the input keys' type when FIRST.
template <typename K, typename Map, bool FIRST, bool LAST, bool GROUPED,
          typename In = long long>
__device__ __forceinline__ void sort_pass_body(
    const void* __restrict__ keys_in, const int* __restrict__ idx_in, int n,
    const SortPlan& plan, int pass, const unsigned* __restrict__ hist,
    unsigned long long* state, void* __restrict__ keys_out,
    void* __restrict__ idx_out) {
  constexpr int ITEMS = sort_items(sizeof(K));
  constexpr int TILE = SORT_THREADS * ITEMS;
  constexpr int WARPS = SORT_THREADS / 32;
  static_assert(SORT_THREADS == SORT_RADIX, "a thread a digit");
  __shared__ K staged_keys[TILE];
  __shared__ int staged_idx[TILE];
  // each warp's count of each digit, then its exclusive prefix over the
  // tile's warps
  __shared__ unsigned short warp_count[WARPS][SORT_RADIX];
  // where the tile's keys of a digit go: output index - staged index
  __shared__ int shift_out[SORT_RADIX];
  // where the tile's keys of a digit start in the staged tile
  __shared__ unsigned short digit_start[SORT_RADIX];
  __shared__ unsigned scan_shared[2 * 33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int own = warp * 32 * ITEMS + lane;
  for (int w = 0; w < WARPS; ++w) warp_count[w][threadIdx.x] = 0;

  // the warp's keys, in order: tile blockIdx.x's in flight while the
  // ticket is taken (its barrier also orders the clearing above)
  K key[ITEMS];
  int idx[ITEMS];
  const auto load = [&](int t0) {
    const long long first = (long long)t0 * TILE;
    const int tile_n = (int)min((long long)TILE, n - first);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int t = own + 32 * i;
      const bool valid = t < tile_n;
      if (FIRST) {
        key[i] = valid ? Map::in(__ldg(static_cast<const In*>(keys_in) +
                                       first + t),
                                 plan.top)
                       : (K)0;
        idx[i] = (int)(first + t);
      } else {
        key[i] = valid ? __ldg(static_cast<const K*>(keys_in) + first + t)
                       : (K)0;
        idx[i] = valid ? __ldg(idx_in + first + t) : 0;
      }
    }
  };
  load(blockIdx.x);
  const int tile = scan_ticket(state);
  if (tile != (int)blockIdx.x) load(tile);
  const int shift = plan.shift[pass], bits = plan.bits[pass];
  const int tile_n = (int)min((long long)TILE, n - (long long)tile * TILE);

  // ranks in the warp, item by item
  const unsigned below_me = (1u << lane) - 1u;
  unsigned short rank[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool valid = own + 32 * i < tile_n;
    const unsigned d = sort_digit(key[i], shift, bits);
    const unsigned peers = sort_match_digit(d, valid);
    const unsigned before = (unsigned)__popc(peers & below_me);
    const unsigned c = valid ? warp_count[warp][d] : 0u;
    rank[i] = (unsigned short)(c + before);
    __syncwarp();
    if (valid && before == 0u)
      warp_count[warp][d] = (unsigned short)(c + __popc(peers));
    __syncwarp();
  }
  __syncthreads();

  // thread d: the warps' prefixes of digit d and the tile's count,
  // published
  const int d = threadIdx.x;
  unsigned count = 0;
  for (int w = 0; w < WARPS; ++w) {
    const unsigned c = warp_count[w][d];
    warp_count[w][d] = (unsigned short)count;
    count += c;
  }
  // the look-back's words (sort_pass_words): the decoupled look-back's
  // status words, or the two-level one's counts, group sums and group
  // prefixes
  const long long tiles = ((long long)n + TILE - 1) / TILE;
  unsigned long long* const status = state + 1;
  unsigned* const tile_counts = reinterpret_cast<unsigned*>(state + 1);
  unsigned* const group_sums = tile_counts + tiles * SORT_RADIX;
  unsigned* const group_excl =
      group_sums + (tiles + SCAN_GROUP - 1) / SCAN_GROUP * SORT_RADIX;
  unsigned long long* const word = status + (long long)tile * SORT_RADIX + d;
  if (GROUPED)
    scan_publish_in_group(tile_counts + d, group_sums + d, SORT_RADIX, tile,
                          count);
  else
    scan_publish(word, tile == 0 ? SCAN_INCLUSIVE : SCAN_AGGREGATE, count);
  // the tile's digit starts, and the digits' starts in the output
  const unsigned v[2] = {count, __ldg(&hist[pass * SORT_RADIX + d])};
  unsigned excl[2], total[2];
  scan_cta<2>(v, excl, total, scan_shared);
  // the count of digit d in the lower tiles: all of it now (decoupled; a
  // group's first tile, which publishes it as the group's), or after the
  // staging (the group's other tiles, which gives the first the time)
  const int g = tile / SCAN_GROUP;
  const bool in_group = GROUPED && tile % SCAN_GROUP != 0;
  unsigned long long below = 0;
  if (GROUPED && !in_group && g > 0) {
    below = scan_lookback_group(group_excl + d, group_sums + d, SORT_RADIX, g);
    scan_store32(group_excl + (long long)g * SORT_RADIX + d,
                 scan_excl_word((unsigned)below));
  } else if (!GROUPED && tile > 0) {
    below = scan_lookback(status + d, SORT_RADIX, tile);
    scan_publish(word, SCAN_INCLUSIVE, below + count);
  }
  digit_start[d] = (unsigned short)excl[0];
  __syncthreads();
  // stage the tile in digit order (warp_count now holds each warp's
  // prefix of each digit)
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (own + 32 * i >= tile_n) continue;
    const unsigned dd = sort_digit(key[i], shift, bits);
    const int at = digit_start[dd] + warp_count[warp][dd] + rank[i];
    staged_keys[at] = key[i];
    staged_idx[at] = idx[i];
  }
  if (in_group)
    below = scan_lookback_in_group(tile_counts + d, group_excl + d,
                                   SORT_RADIX, tile);
  shift_out[d] = (int)(excl[1] + below) - (int)excl[0];
  __syncthreads();
  for (int t = threadIdx.x; t < tile_n; t += SORT_THREADS) {
    const K k = staged_keys[t];
    const int at = shift_out[sort_digit(k, shift, bits)] + t;
    if (LAST) {
      static_cast<long long*>(keys_out)[at] = Map::out(k, plan.top);
      static_cast<long long*>(idx_out)[at] = staged_idx[t];
    } else {
      static_cast<K*>(keys_out)[at] = k;
      static_cast<int*>(idx_out)[at] = staged_idx[t];
    }
  }
}

#endif  // __CUDACC__
