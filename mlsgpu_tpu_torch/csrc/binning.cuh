// The per-item arithmetic of the binning kernels (binning.cu): one
// splat's eight node keys, the radix sort's digit plan and its map of the
// keys to 32 bits, one tile's ancestor node at a level, the searches of
// the sorted keys that find each node's first entry, and an entry row's
// 1/r^2.
//
// Written once for the card and for a host build: nvcc compiles these
// functions into the kernels, where every float product and sum is an
// `_rn` intrinsic (never contracted into an FMA) and the int64 -> f32
// conversion `__ll2float_rn`; a host compiler (g++ -ffp-contract=off) gets
// the same operations as plain IEEE float arithmetic, so a CPU test can
// hold this arithmetic to the plain version (ops/binning.py) bit for bit
// without a card. The order of every sum is the plain version's.
//
// Node keys and node boundaries are 32-bit: a node address has at most
// 10 bits an axis (max_shift - min_shift <= 10), so its Morton code fits
// 30 bits, and a level's offset plus a code stays below the key space of
// 11 levels, under 2^31 (the static_assert below). Only the block's
// origin needs 64 bits: `lo - org` and the slab faces `(a << s) + org`.

#pragma once

#include <math.h>

#include "radix_sort.cuh"

#if defined(__CUDACC__)
#define BIN_FN __host__ __device__ __forceinline__
#else
#define BIN_FN static inline
#endif

// ops/binning.py::INVALID_KEY: sorts after every node key.
#define BIN_INVALID_KEY 0xFFFFFFFFLL
// float(np.float32(1.00001)), octree.cl:194's conservative factor as the
// plain version rounds it (0x3f800054).
#define BIN_R2_FACTOR 0x1.0000a8p+0f
// The node shifts the kernels take: 3 <= min_shift <= max_shift <= 13.
#define BIN_MIN_SHIFT 3
#define BIN_MAX_SHIFT 13
#define BIN_MAX_LEVELS (BIN_MAX_SHIFT - BIN_MIN_SHIFT + 1)
// The node boundaries one CTA of the bounds pass takes.
#define BIN_BOUND_THREADS 256

// The number of node keys of `levels` levels: 8^(levels-1) + ... + 8 + 1
// (level_offsets' end).
constexpr long long bin_key_space(int levels) {
  return levels == 0 ? 0 : 8 * bin_key_space(levels - 1) + 1;
}
static_assert(bin_key_space(BIN_MAX_LEVELS) < (1LL << 31),
              "node keys and node boundaries must fit an int");

struct BinShape {
  int min_shift;  // leaf node size = 2^min_shift cells
  int max_shift;  // root node size = 2^max_shift cells
  long long org[3];  // the block's first cell, x y z
  // level_offsets(min_shift, max_shift): the key-space offset of the
  // level li shifts above the leaves
  int level_offset[BIN_MAX_LEVELS];
};

// The BinShape of a block (the caller checks the shifts).
static inline BinShape bin_shape(int min_shift, int max_shift, long long ox,
                                 long long oy, long long oz) {
  BinShape s{min_shift, max_shift, {ox, oy, oz}, {}};
  for (int li = 0; li <= max_shift - min_shift; ++li)
    s.level_offset[li] =
        (int)(bin_key_space(max_shift - min_shift + 1) -
              bin_key_space(max_shift - min_shift + 1 - li));
  return s;
}

// The node keys of a block: every key is below this, and the bounds pass
// finds the first entry of each node key and of this one.
static inline int bin_nodes(const BinShape& s) {
  return (int)bin_key_space(s.max_shift - s.min_shift + 1);
}

BIN_FN float bin_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

BIN_FN float bin_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

BIN_FN float bin_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

// int64 -> f32, round to nearest (torch's `.to(torch.float32)`).
BIN_FN float bin_i2f(long long x) {
#ifdef __CUDA_ARCH__
  return __ll2float_rn(x);
#else
  return (float)x;
#endif
}

// 1.0 / (r * r) as torch computes it: reciprocal(r * r), correctly rounded.
BIN_FN float bin_inv_r2(float r) {
#ifdef __CUDA_ARCH__
  return __frcp_rn(__fmul_rn(r, r));
#else
  return 1.0f / (r * r);
#endif
}

// Bits needed for x >= 1, saturated at 31 (ops/binning.py::bit_length).
BIN_FN int bin_bit_length(long long x) {
#ifdef __CUDA_ARCH__
  const int bits = 64 - __clzll(x);
#else
  const int bits = 64 - __builtin_clzll((unsigned long long)x);
#endif
  return bits < 31 ? bits : 31;
}

// The radix sort (bin_sort_*_kernel, on radix_sort.cuh): a stable LSD
// sort of the node keys in digits of at most BIN_SORT_DIGIT_BITS bits, a
// CTA of BIN_SORT_THREADS threads (a thread a digit) ranking a tile of
// BIN_SORT_TILE keys, BIN_SORT_ITEMS a thread (32-bit keys between
// passes).
#define BIN_SORT_DIGIT_BITS SORT_DIGIT_BITS
#define BIN_SORT_RADIX SORT_RADIX
#define BIN_SORT_MAX_PASSES SORT_MAX_PASSES
#define BIN_SORT_THREADS SORT_THREADS
#define BIN_SORT_ITEMS 16
#define BIN_SORT_TILE (BIN_SORT_THREADS * BIN_SORT_ITEMS)
static_assert(BIN_SORT_TILE == sort_tile_keys(4), "32-bit sort keys");

// A sort's digits: every key of the shifts is below `top` = K (the node
// keys, bin_nodes), and BIN_INVALID_KEY sorts as `top` itself, so the
// keys take bit_length(K) bits, cut into passes of BIN_SORT_DIGIT_BITS
// from the lowest bit (the last pass takes what is left): 2 passes at 6
// levels (16 bits), 3 at 7 (19), 4 at 11 (31). (Digits of 10 bits, 2
// passes at 7 levels, took the H100 1.6x as long: their look-back, four
// digits a thread, cost more than the pass they saved.)
typedef SortPlan BinSortPlan;

static inline BinSortPlan bin_sort_plan(int min_shift, int max_shift) {
  const long long top = bin_key_space(max_shift - min_shift + 1);
  return sort_plan(bin_bit_length(top), (unsigned)top);
}

// A node key as the sort's 32-bit key: itself, BIN_INVALID_KEY as `top`.
BIN_FN unsigned bin_sort_map(long long key, unsigned top) {
  return key == BIN_INVALID_KEY ? top : (unsigned)key;
}

BIN_FN long long bin_sort_unmap(unsigned m, unsigned top) {
  return m == top ? BIN_INVALID_KEY : (long long)m;
}

BIN_FN unsigned bin_sort_digit(unsigned m, int shift, int bits) {
  return sort_digit(m, shift, bits);
}

// The tiles of n keys, and the 64-bit words of a sort's scratch
// (radix_sort.cuh): the passes' histograms, then each pass's ticket and
// status words.
static inline long long bin_sort_tiles(long long n) { return sort_tiles(n, 4); }

static inline long long bin_sort_pass_words(long long n) {
  return sort_pass_words(n, 4);
}

static inline long long bin_sort_scratch_words(long long n, int passes) {
  return sort_scratch_words(n, passes, 4);
}

#if defined(__CUDACC__)
// The node keys' map to and from the sort's 32-bit keys (radix_sort.cuh).
struct BinNodeMap {
  static __device__ __forceinline__ unsigned in(long long key, unsigned top) {
    return bin_sort_map(key, top);
  }
  static __device__ __forceinline__ long long out(unsigned m, unsigned top) {
    return bin_sort_unmap(m, top);
  }
};
#endif

// morton.py::_part1by2 in 32 bits: the low 10 bits of x, two zero bits
// between each.
BIN_FN unsigned bin_spread(unsigned x) {
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

// morton.py::encode: 10 bits an axis, z-major.
BIN_FN unsigned bin_morton(unsigned x, unsigned y, unsigned z) {
  return bin_spread(x) | (bin_spread(y) << 1) | (bin_spread(z) << 2);
}

// torch.clamp(v, min=lo, max=hi) with tensor bounds: NaN propagates.
BIN_FN float bin_clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// splat_keys for one splat (px, py, pz, r): its key for corner
// c = dz * 4 + dy * 2 + dx into keys[c], BIN_INVALID_KEY where the splat
// is invalid, misses the node or the node lies outside the block. Each
// axis address is spread once and the corners' codes are ORs of them.
BIN_FN void bin_splat_keys(float px, float py, float pz, float r, bool valid,
                           const BinShape& s, long long keys[8]) {
  const float p[3] = {px, py, pz};
  long long lo[3], big = 0;
  for (int a = 0; a < 3; ++a) {
    lo[a] = (long long)floorf(bin_sub(p[a], r));
    const long long span = (long long)floorf(bin_add(p[a], r)) - lo[a];
    big = a == 0 ? span : (span > big ? span : big);
  }
  // level_shift: clamp(bit_length(max(big - 1, 1)) where big > 1, else 0)
  int shift = big > 1 ? bin_bit_length(big - 1 > 1 ? big - 1 : 1) : 0;
  shift = shift < s.min_shift ? s.min_shift
                              : (shift > s.max_shift ? s.max_shift : shift);
  const unsigned level_offset = (unsigned)s.level_offset[shift - s.min_shift];
  const long long bound = 1LL << (s.max_shift - shift);
  const float r2c = bin_mul(bin_mul(r, r), BIN_R2_FACTOR);
  // axis a, d in {0, 1}: the node address ilo + d, spread and moved to
  // its axis' bits, whether it lies in the block, and the squared distance
  // from the splat to that node's slab [face d, face d + 1) at `shift`
  unsigned code[3][2];
  bool in[3][2];
  float d2[3][2];
  for (int a = 0; a < 3; ++a) {
    const long long rel = lo[a] - s.org[a];
    const long long ilo = (rel > 0 ? rel : 0) >> shift;
    float face[3];
    for (int k = 0; k < 3; ++k)
      face[k] = bin_i2f(((ilo + k) << shift) + s.org[a]);
    for (int d = 0; d < 2; ++d) {
      const float dd = bin_sub(bin_clamp(p[a], face[d], face[d + 1]), p[a]);
      d2[a][d] = bin_mul(dd, dd);
      in[a][d] = ilo + d < bound;
      code[a][d] = bin_spread((unsigned)(ilo + d)) << a;
    }
  }
  for (int c = 0; c < 8; ++c) {
    const int dx = c & 1, dy = (c >> 1) & 1, dz = c >> 2;
    const bool isect = bin_add(bin_add(d2[0][dx], d2[1][dy]), d2[2][dz]) < r2c;
    const bool ok = isect && in[0][dx] && in[1][dy] && in[2][dz] && valid;
    const unsigned key = level_offset + (code[0][dx] | code[1][dy] | code[2][dz]);
    keys[c] = ok ? (long long)key : BIN_INVALID_KEY;
  }
}

// tile_segments' query for tile t (tiles in (tz, ty, tx) C order, tpa <=
// 2^(max_shift - 3) an axis): the Morton code of the tile.
BIN_FN unsigned bin_tile_code(unsigned t, unsigned tpa) {
  const unsigned tq = t / tpa;
  return bin_morton(t - tq * tpa, tq % tpa, tq / tpa);
}

// The key of the ancestor at level li of the tile with Morton code
// `code`: the code shifted to the level (morton(t) >> 3k == morton(t >>
// k)) plus the level's offset.
BIN_FN int bin_level_node(unsigned code, int li, const BinShape& s) {
  return (int)((code >> (3 * (s.min_shift - 3 + li))) +
               (unsigned)s.level_offset[li]);
}

// The first index in sorted keys[lo, hi) whose key is not below q, or hi
// (torch.searchsorted(side="left") on that range).
BIN_FN int bin_lower_bound(const long long* keys, int lo, int hi,
                           long long q) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (keys[mid] < q)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// A 32-ary search for a lower bound, one probe a lane of a warp: the
// answer lies in [lo, hi] (keys[hi] is not below q, or hi is the end). A
// round cuts [lo, hi) into 32 parts of bin_part keys; lane l probes the
// last key of part l (bin_probe: its index, or -1 past hi), and
// bin_narrow takes the number of probes below q, which are a prefix of
// the lanes. Unsigned: lo + 32 parts may pass hi by 31.
BIN_FN unsigned bin_part(int lo, int hi) {
  return ((unsigned)(hi - lo) + 31u) >> 5;
}

BIN_FN int bin_probe(int lo, int hi, int lane) {
  const unsigned idx = (unsigned)lo + (unsigned)(lane + 1) * bin_part(lo, hi) - 1u;
  return idx < (unsigned)hi ? (int)idx : -1;
}

BIN_FN void bin_narrow(int& lo, int& hi, int below) {
  const unsigned part = bin_part(lo, hi);
  const unsigned nlo = (unsigned)lo + (unsigned)below * part;
  const unsigned nhi = nlo + part - 1u;
  lo = nlo < (unsigned)hi ? (int)nlo : hi;
  hi = nhi < (unsigned)hi ? (int)nhi : hi;
}
