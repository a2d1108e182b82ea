// A device-wide exclusive scan of integer counts in a single launch: the
// decoupled look-back that march_scan_kernel (marching.cu), the radix
// sort's passes (binning.cu, bin_sort_pass_kernel; mesh.cu) and the
// weld's group kernel (mesh.cu) are built on.
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
// The flag and the value share one word, written and read whole (a
// 64-bit relaxed store and load at GPU scope), so a reader never sees a
// flag with another state's value, and nothing else needs a fence: what
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
// The packing and the look-back's window step are plain host-compilable
// code, so the g++ host builds of the tests check them and emulate the
// kernels' scans tile by tile.

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
