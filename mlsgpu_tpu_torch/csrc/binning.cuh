// The per-item arithmetic of the binning kernels (binning.cu): one
// splat's eight node keys, one tile's ancestor node at a level, a lower
// bound in the sorted keys, and an entry row's 1/r^2.
//
// Written once for the card and for a host build: nvcc compiles these
// functions into the kernels, where every float product and sum is an
// `_rn` intrinsic (never contracted into an FMA) and the int64 -> f32
// conversion `__ll2float_rn`; a host compiler (g++ -ffp-contract=off) gets
// the same operations as plain IEEE float arithmetic, so a CPU test can
// hold this arithmetic to the plain version (ops/binning.py) bit for bit
// without a card. The order of every sum is the plain version's.

#pragma once

#include <math.h>

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

struct BinShape {
  int min_shift;  // leaf node size = 2^min_shift cells
  int max_shift;  // root node size = 2^max_shift cells
  long long org[3];  // the block's first cell, x y z
};

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

// morton.py::_part1by2 / encode: 10 bits an axis, z-major.
BIN_FN long long bin_part1by2(long long x) {
  x &= 0x3FF;
  x = (x | (x << 16)) & 0x30000FF;
  x = (x | (x << 8)) & 0x300F00F;
  x = (x | (x << 4)) & 0x30C30C3;
  x = (x | (x << 2)) & 0x9249249;
  return x;
}

BIN_FN long long bin_encode(long long x, long long y, long long z) {
  return bin_part1by2(x) | (bin_part1by2(y) << 1) | (bin_part1by2(z) << 2);
}

// level_offsets(min_shift, max_shift)[li]: the key-space offset of the
// level li shifts above the leaves.
BIN_FN long long bin_level_offset(int li, int min_shift, int max_shift) {
  long long off = 0;
  for (int k = 0; k < li; ++k) off += 1LL << (3 * (max_shift - min_shift - k));
  return off;
}

// torch.clamp(v, min=lo, max=hi) with tensor bounds: NaN propagates.
BIN_FN float bin_clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// splat_keys for one splat (px, py, pz, r): its key for corner
// c = dz * 4 + dy * 2 + dx into keys[c], BIN_INVALID_KEY where the splat
// is invalid, misses the node or the node lies outside the block.
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
  const long long level_offset =
      bin_level_offset(shift - s.min_shift, s.min_shift, s.max_shift);
  const long long bound = 1LL << (s.max_shift - shift);
  const float r2c = bin_mul(bin_mul(r, r), BIN_R2_FACTOR);
  // axis a, d in {0, 1}: the node address and the squared distance from
  // the splat to that node's slab [addr, addr + 1) at `shift`
  long long addr[3][2];
  float d2[3][2];
  for (int a = 0; a < 3; ++a) {
    const long long rel = lo[a] - s.org[a];
    const long long ilo = (rel > 0 ? rel : 0) >> shift;
    for (int d = 0; d < 2; ++d) {
      const long long ad = ilo + d;
      const float blo = bin_i2f((ad << shift) + s.org[a]);
      const float bhi = bin_i2f(((ad + 1) << shift) + s.org[a]);
      const float dd = bin_sub(bin_clamp(p[a], blo, bhi), p[a]);
      addr[a][d] = ad;
      d2[a][d] = bin_mul(dd, dd);
    }
  }
  for (int c = 0; c < 8; ++c) {
    const int dx = c & 1, dy = (c >> 1) & 1, dz = c >> 2;
    const long long ax = addr[0][dx], ay = addr[1][dy], az = addr[2][dz];
    const bool isect = bin_add(bin_add(d2[0][dx], d2[1][dy]), d2[2][dz]) < r2c;
    const bool inb = ax < bound && ay < bound && az < bound;
    keys[c] = isect && inb && valid ? level_offset + bin_encode(ax, ay, az)
                                    : BIN_INVALID_KEY;
  }
}

// tile_segments' query for tile t (tiles in (tz, ty, tx) C order) at level
// li: its ancestor node's key (the Morton code of t shifted to the level,
// morton(t) >> 3k == morton(t >> k), plus the level's offset).
BIN_FN long long bin_tile_node(long long t, int tpa, int li, int min_shift,
                               int max_shift) {
  const long long tx = t % tpa, ty = (t / tpa) % tpa, tz = t / tpa / tpa;
  return (bin_encode(tx, ty, tz) >> (3 * (min_shift - 3 + li))) +
         bin_level_offset(li, min_shift, max_shift);
}

// The first index in sorted keys[0, n) whose key is not below q
// (torch.searchsorted(side="left")).
BIN_FN long long bin_lower_bound(const long long* keys, long long n,
                                 long long q) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (keys[mid] < q)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}
