// A device-wide exclusive scan of integer counts in a single launch: the
// decoupled look-back that march_scan_kernel (marching.cu), the weld's
// group kernel (mesh.cu) and the radix sort's passes of many waves are
// built on, and the two-level look-back of the sort's passes of about one
// wave (radix_sort.cuh: binning.cu's bin_sort_pass_kernel, mesh.cu's
// weld_sort_pass_kernel).
//
// Each CTA of such a kernel takes a tile (a contiguous range of the items)
// by ticket: thread 0 adds one to a counter of the launch (scan_ticket),
// and the CTA works on the tile the counter held. The tiles are taken in
// the order the CTAs start, so a CTA that waits for a tile below its own
// waits for a CTA that took its ticket earlier and is already running:
// no CTA ever waits for one that is not yet resident (a CTA that waited on
// a lower blockIdx could, and could hang two such launches on two
// streams). For each of its counts a tile has one 64-bit status word:
// empty, then its aggregate (the tile's own sum) as soon as the tile has
// it, then its inclusive prefix (the sum over every tile up to it). A
// tile finds its exclusive prefix by looking back over lower tiles
// (scan_lookback): it adds their aggregates until it meets an inclusive
// prefix, SCAN_WINDOW predecessors a round. Tile 0 writes its inclusive
// prefix at once, so every look-back ends. Only counts are scanned, as
// unsigned integers: the results are exact and do not depend on the
// order in which the CTAs run.
//
// When every tile of a launch runs at once and publishes at about the same
// moment (one wave: the radix sort's 162-190 tiles at 256^3 on 132 SMs),
// such a look-back walks the wave: tile t meets an inclusive prefix only
// about t / 8 rounds back (on the H100 up to 11 rounds at 256^3, 2.3-2.7 us
// a pass, and the latest tiles end ~3 us after the first). The two-level
// look-back (scan_lookback_group, scan_lookback_in_group) is for such a
// launch: consecutive tickets form groups of SCAN_GROUP tiles; a tile
// publishes its count once, as a 32-bit word (scan_count_word), and adds
// it, tagged with a one in the top byte, into its group's 32-bit sum word
// (scan_group_add), so a group's sum is complete once every tile of it has
// published. The first tile of each group g > 0 finds the group's
// exclusive prefix over the groups below (nearest first,
// SCAN_GROUP_WINDOW a round, each group its complete sum, or its
// published exclusive prefix plus its sum, which ends the walk) and
// publishes it (scan_excl_word); every other tile reads that word and the
// counts of its group's lower tiles, all at once, one round. Its words are
// 32-bit (the counts of a tile and a group are small; a prefix is below
// 2^31), and only the first tiles of the groups look further back (64-bit
// words, up to 31 a round, took as long as the walk: their L2 bytes). A
// tile waits only on lower tickets: its group's lower tiles and first
// tile, and (a first tile) the tiles and first tiles of the groups below.
// It holds more registers than scan_lookback, so that a launch of many
// waves, whose later waves find inclusive prefixes at once, keeps the
// decoupled look-back (radix_sort.cuh picks by the tiles).
//
// The flag and the value share one word, written and read whole (a
// 64-bit relaxed store and load at GPU scope; the two-level look-back's
// 32-bit words likewise, a value plus one or a group's tile count beside
// its sum), so a reader never sees a flag with another state's value, and
// nothing else needs a fence: what
// the tiles write besides (the scan's list, the sort's keys) is read by
// later kernels on the stream.
//
// The per-call state (the ticket and the status words) must be zero when
// the launch starts. It is cleared by the kernel before it on the stream,
// which runs anyway: march_classify_kernel clears the scan's, and the
// sort's histogram kernel clears its passes'. That costs no launch and no
// host work, the scratch can be a fresh torch.empty each call (calls on
// two streams never share it), and no word is ever left from an earlier
// call. (Tagging each word with a call epoch would need the state to
// persist across calls, one copy a stream, and the ticket reset anyway.)
//
// The packing, the look-back's window step and the group words are plain
// host-compilable code, so the g++ host builds of the tests check them and
// emulate the kernels' scans tile by tile.

#pragma once

#if defined(__CUDACC__)
#define SCAN_FN __host__ __device__ __forceinline__
#else
#define SCAN_FN static inline
#endif

// A status word: the flag in the top two bits, the value below.
#define SCAN_EMPTY 0u
#define SCAN_AGGREGATE 1u
#define SCAN_INCLUSIVE 2u
#define SCAN_VALUE_BITS 62
#define SCAN_VALUE_MASK ((1ULL << SCAN_VALUE_BITS) - 1ULL)
// Predecessors a look-back reads a round, their loads in flight together:
// on the H100 the sort's passes took 0.109 ms at 512^3 with 4 against
// 0.118 with 8 (wider rounds load more words than the few rounds a
// look-back takes need; 32 was slower still).
#define SCAN_WINDOW 4
// Predecessors a warp's look-back (scan_lookback_warp) reads a round, a
// lane each: for a kernel with a few counts a tile, whose CTAs publish in
// waves, so that a look-back walks back over many aggregates.
#define SCAN_WARP_WINDOW 32
// The two-level look-back's groups: SCAN_GROUP consecutive tiles (a tile
// loads its group's lower tiles' counts at once, SCAN_GROUP - 1 at most),
// and the groups a round of a first tile's look-back over groups reads.
#define SCAN_GROUP 16
#define SCAN_GROUP_WINDOW 8
// A group's sum word: its tiles' counts below bit SCAN_GROUP_SHIFT (a
// sort's tile holds at most 4,096 keys, so a group's sum is below 2^17),
// the number of tiles that added theirs above it.
#define SCAN_GROUP_SHIFT 24
#define SCAN_GROUP_MASK ((1u << SCAN_GROUP_SHIFT) - 1u)

SCAN_FN unsigned long long scan_word(unsigned flag, unsigned long long value) {
  return ((unsigned long long)flag << SCAN_VALUE_BITS) |
         (value & SCAN_VALUE_MASK);
}

SCAN_FN unsigned scan_flag(unsigned long long word) {
  return (unsigned)(word >> SCAN_VALUE_BITS);
}

SCAN_FN unsigned long long scan_value(unsigned long long word) {
  return word & SCAN_VALUE_MASK;
}

// One round of a look-back: the words of the `n` nearest predecessors not
// yet taken, nearest first. Adds their values to `sum` up to the first
// inclusive prefix or up to the first empty word, whichever comes first.
// Returns the words taken; *done is set when an inclusive prefix was
// among them (then `sum` is the exclusive prefix).
SCAN_FN int scan_window_step(const unsigned long long* words, int n,
                             unsigned long long& sum, bool* done) {
  *done = false;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const unsigned flag = scan_flag(words[i]);
    if (flag == SCAN_EMPTY) return i;
    sum += scan_value(words[i]);
    if (flag == SCAN_INCLUSIVE) {
      *done = true;
      return i + 1;
    }
  }
  return n;
}

// The two-level look-back's 32-bit words, zero while empty: a tile's count
// and a group's exclusive prefix (below 2^31), each published as itself
// plus one.
SCAN_FN unsigned scan_count_word(unsigned count) { return count + 1u; }
SCAN_FN unsigned scan_excl_word(unsigned prefix) { return prefix + 1u; }

// What a tile adds to its group's sum word: its count, and one tile.
SCAN_FN unsigned scan_group_add(unsigned count) {
  return (1u << SCAN_GROUP_SHIFT) + count;
}

// A group below the reader's as a first tile's look-back takes it
// (scan_window_step's words): empty until all SCAN_GROUP tiles have added
// their counts to its sum word; then its exclusive prefix plus its sum as
// an inclusive prefix where its first tile has published the former
// (`excl`), else its sum as an aggregate. Group 0's exclusive prefix is 0
// without a word (`first`).
SCAN_FN unsigned long long scan_group_status(unsigned excl, unsigned sum,
                                             bool first) {
  if ((sum >> SCAN_GROUP_SHIFT) != SCAN_GROUP) return scan_word(SCAN_EMPTY, 0);
  const unsigned long long s = sum & SCAN_GROUP_MASK;
  if (first) return scan_word(SCAN_INCLUSIVE, s);
  return excl != 0u ? scan_word(SCAN_INCLUSIVE, excl - 1ULL + s)
                    : scan_word(SCAN_AGGREGATE, s);
}

#if defined(__CUDACC__)

__device__ __forceinline__ unsigned long long scan_load(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void scan_store(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The CTA's tile: thread 0 takes a ticket, every thread returns it. Call
// from every thread of the CTA (it holds a CTA barrier).
__device__ __forceinline__ int scan_ticket(unsigned long long* counter) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = (int)atomicAdd(counter, 1ULL);
  __syncthreads();
  return ticket;
}

// Publish a tile's count: its aggregate, or (tile 0, or once the
// look-back is done) its inclusive prefix.
__device__ __forceinline__ void scan_publish(unsigned long long* word,
                                             unsigned flag,
                                             unsigned long long value) {
  scan_store(word, scan_word(flag, value));
}

// The exclusive prefix of `tile` for one count, whose status word of tile
// p is words[p * stride]: a look-back by the calling thread alone,
// SCAN_WINDOW lower tiles a round (the loads of a round in flight
// together; below tile 0 an inclusive 0 stands in, so every round takes a
// whole window and the window stays in registers), spinning on a round
// whose nearest untaken word is empty.
__device__ __forceinline__ unsigned long long scan_lookback(
    const unsigned long long* words, int stride, int tile) {
  unsigned long long sum = 0, w[SCAN_WINDOW];
  int next = tile - 1;  // the nearest lower tile not yet taken
  while (next >= 0) {
#pragma unroll
    for (int i = 0; i < SCAN_WINDOW; ++i)
      w[i] = next - i >= 0
                 ? scan_load(words + (long long)(next - i) * stride)
                 : scan_word(SCAN_INCLUSIVE, 0ULL);
    bool done;
    next -= scan_window_step(w, SCAN_WINDOW, sum, &done);
    if (done) break;
  }
  return sum;
}

// The exclusive prefix of `tile` for one count, as scan_lookback, by a
// whole warp (every lane calls it and gets it): SCAN_WARP_WINDOW lower
// tiles a round, a lane each, nearest first; a round takes its words
// before the first empty one, up to and with the first inclusive prefix
// (scan_window_step's rule), summed across the lanes.
__device__ __forceinline__ unsigned long long scan_lookback_warp(
    const unsigned long long* words, int stride, int tile) {
  const int lane = threadIdx.x & 31;
  unsigned long long sum = 0;
  int next = tile - 1;
  while (next >= 0) {
    const int p = next - lane;
    const unsigned long long w =
        p >= 0 ? scan_load(words + (long long)p * stride)
               : scan_word(SCAN_INCLUSIVE, 0ULL);
    const unsigned empty =
        __ballot_sync(0xFFFFFFFFu, scan_flag(w) == SCAN_EMPTY);
    const unsigned incl =
        __ballot_sync(0xFFFFFFFFu, scan_flag(w) == SCAN_INCLUSIVE);
    const unsigned before_empty =
        empty ? (1u << (__ffs(empty) - 1)) - 1u : 0xFFFFFFFFu;
    const unsigned upto_incl = incl ? ((incl & (0u - incl)) << 1) - 1u
                                    : 0xFFFFFFFFu;
    const unsigned take = before_empty & upto_incl;
    unsigned long long v = (take >> lane) & 1u ? scan_value(w) : 0ULL;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    sum += v;
    if (incl & take) break;
    next -= __popc(take);
  }
  return sum;
}

__device__ __forceinline__ unsigned scan_load32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void scan_store32(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Publish a tile's count for the two-level look-back: its count word
// (counts[tile * stride]) and its share of its group's sum word
// (sums[g * stride]; one atomic add, in any order).
__device__ __forceinline__ void scan_publish_in_group(unsigned* counts,
                                                      unsigned* sums,
                                                      int stride, int tile,
                                                      unsigned count) {
  scan_store32(counts + (long long)tile * stride, scan_count_word(count));
  atomicAdd(sums + (long long)(tile / SCAN_GROUP) * stride,
            scan_group_add(count));
}

// The exclusive prefix of group g > 0 for one count (the sum of every
// count in the groups below), by its first tile's thread alone: the groups
// below nearest first, SCAN_GROUP_WINDOW a round (their exclusive and sum
// words loaded together: excl[q * stride], sums[q * stride]), spinning on
// a round whose nearest untaken group is not complete. The caller
// publishes it (scan_excl_word).
__device__ __forceinline__ unsigned long long scan_lookback_group(
    const unsigned* excl, const unsigned* sums, int stride, int g) {
  unsigned long long sum = 0, w[SCAN_GROUP_WINDOW];
  int next = g - 1;  // the nearest lower group not yet taken
  bool done = false;
  while (!done) {
#pragma unroll
    for (int i = 0; i < SCAN_GROUP_WINDOW; ++i) {
      const int q = next - i;
      w[i] = q >= 0 ? scan_group_status(
                          q > 0 ? scan_load32(excl + (long long)q * stride)
                                : 0u,
                          scan_load32(sums + (long long)q * stride), q == 0)
                    : scan_word(SCAN_INCLUSIVE, 0ULL);
    }
    next -= scan_window_step(w, SCAN_GROUP_WINDOW, sum, &done);
  }
  return sum;
}

// The exclusive prefix of `tile` for one count, by the calling thread
// alone, where the tile is not the first of its group: its group's
// exclusive prefix (excl[g * stride], 0 for group 0) plus the counts of its
// group's lower tiles (counts[p * stride]), all loaded at once, spinning on
// each word until it is published.
__device__ __forceinline__ unsigned long long scan_lookback_in_group(
    const unsigned* counts, const unsigned* excl, int stride, int tile) {
  const int g = tile / SCAN_GROUP, r = tile - g * SCAN_GROUP;
  const unsigned* const e = excl + (long long)g * stride;
  unsigned x = g > 0 ? scan_load32(e) : 1u, w[SCAN_GROUP - 1];
#pragma unroll
  for (int i = 0; i < SCAN_GROUP - 1; ++i)
    w[i] = i < r ? scan_load32(counts + (long long)(tile - 1 - i) * stride)
                 : 1u;
  unsigned long long sum = 0;
#pragma unroll
  for (int i = 0; i < SCAN_GROUP - 1; ++i) {
    while (w[i] == 0u)
      w[i] = scan_load32(counts + (long long)(tile - 1 - i) * stride);
    sum += w[i] - 1u;
  }
  while (x == 0u) x = scan_load32(e);
  return sum + (x - 1u);
}

// An exclusive scan of K counts across the CTA's threads (at most 32
// warps): `excl` gets this thread's prefix, `total` the CTA's sums.
// `shared` holds K ints a warp and K more. Call from every thread (it
// holds two CTA barriers).
template <int K>
__device__ __forceinline__ void scan_cta(const unsigned (&v)[K],
                                         unsigned (&excl)[K],
                                         unsigned (&total)[K],
                                         unsigned* shared) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  unsigned inc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) inc[k] = v[k];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned o = __shfl_up_sync(0xFFFFFFFFu, inc[k], d);
      if (lane >= d) inc[k] += o;
    }
  }
  if (lane == 31)
    for (int k = 0; k < K; ++k) shared[K * warp + k] = inc[k];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned w = lane < warps ? shared[K * lane + k] : 0u;
      unsigned s = w;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned o = __shfl_up_sync(0xFFFFFFFFu, s, d);
        if (lane >= d) s += o;
      }
      if (lane < warps) shared[K * lane + k] = s - w;  // exclusive
      if (lane == warps - 1) shared[K * 32 + k] = s;     // the CTA's total
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    excl[k] = shared[K * warp + k] + inc[k] - v[k];
    total[k] = shared[K * 32 + k];
  }
}

#endif  // __CUDACC__
