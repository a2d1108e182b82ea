// The seam passes' moments: the face kernel (every corner of every face
// patch row of a block) and the skeleton kernel (every decomposition-edge
// skeleton point), one launch each per block.
//
// They stand for stages the JAX package compiles with XLA, each into one
// program: the moments of mlsgpu_tpu/ops/mls.py::canonical_face_field
// (:188) and ::skeleton_point_field (:492), jitted at
// mlsgpu_tpu/ops/block.py:636-645. Their plain PyTorch versions are
// mlsgpu_tpu_torch/ops/mls.py::face_moments and ::skeleton_moments, which
// ran as a Python loop of 32-row (64-point) chunks, about 60 launches and
// two host syncs a chunk. ops/mls_cuda.py builds this file with
// mls_field.cu into one library; ops/seam_cuda.py calls the C entry points
// below through ctypes, on PyTorch's current stream, without
// synchronising. The fit and the writes stay the plain PyTorch code.
//
// What a row computes (one CTA per face patch row or skeleton point):
//   * its candidates are the level segments of its covering tiles (the
//     <= 4 distinct tiles of a face row, the one tile of a point), walked
//     in full (no cap), filtered by the exact splat-to-rectangle test of a
//     face row (rect2 * 1/r^2 < 0.99) or the point's own distance test;
//   * they are deduplicated by splat identity (entry_vals) and taken in
//     ascending identity, the stream order;
//   * each corner sums the terms [1, x, |x|^2, n, n.x] * w of the
//     candidates of nonzero weight w = (1-d)^4 q there, in that order, as
//     the pairwise tree of ops/mls.py::_tree_sum over a zero-padded
//     power-of-two axis, and counts the candidates with d < 0.99 (hits).
//
// Design:
//   1. Stream order is not segment order. Binning's sort is stable over
//      entries laid out corner-major (entry c * N + i for corner c of
//      splat i), so a node's segment lists its splats in up to 8 ascending
//      runs, one per corner of the splats' neighbourhoods
//      (tests/test_torch_seam_moments.py checks this), and a merge of the
//      segments by cursors would be wrong. Each round therefore gathers
//      the filtered candidates of an identity window into a buffer in
//      shared memory (a shared counter hands out slots; the order of
//      arrival does not matter), sorts the buffer (bitonic, on the key
//      identity << 32 | entry) and skips repeated identities. Any list
//      length: when the row's candidates overflow the buffer, a binary
//      search over identities (block-wide counts) finds the largest window
//      that fits, and the rounds walk the windows in ascending order. A
//      splat sits at most once in a tile's chain, so a window of one
//      identity holds at most 4 copies: any buffer of >= 4 makes progress.
//   2. The sum is ops/mls.py::_tree_sum's halves tree (slot i with slot
//      i + size/2 first) over the corner's nonzero-weight terms in stream
//      order, padded with zeros to a power of two: it needs no width and
//      depends only on that set of splats in that order, the seam contract
//      by construction. That tree is the tree of neighbouring leaves over
//      the leaves in bit-reversed order, which a binary-counter stack of
//      partial sums builds (push a leaf; left + right while the two top
//      blocks have equal size; fold from the top at the end; adding a
//      zero changes nothing but the sign of a zero). So each corner thread
//      first streams the row's candidates, counting its hits and terms and
//      keeping the entries of its first LIST terms (local memory), then
//      sums those entries in bit-reversed order. A corner with more terms
//      splits their ranks into 2^c residue classes of at most LIST each
//      (more streams of the row, one a class): the tree is the halves tree
//      of the classes' own trees, which a second stack builds over the
//      classes in bit-reversed order of the residue. The stacks and the
//      list live in local memory (~1.6 KB a thread).
//   3. No contraction: every product and sum is __fmul_rn / __fadd_rn /
//      __fsub_rn in the plain version's order (_features, _weights,
//      models/common.py::dot3), so the moments and hits equal the plain
//      version's value for value, on the card and on the CPU.
//   4. A row without candidates writes zeros (its fit is NaN: no hits).
//      The wrapper needs no host sync: no occupied-row list, no width.
//
// The bound (chip_smoke.py seam_bound, from mls.py::face_work and
// skeleton_work on each run's inputs): every listed candidate's filter
// columns (16 bytes) and identity (8 bytes) read once, every kept
// candidate's row (32 bytes) read once, the moments and hits (40 bytes a
// corner) written once; ~45 FP32 operations per (corner, kept candidate)
// pair and ~12 per listed candidate. At the densest 256^3 bucket it is
// bound by the bytes; the kernel is far from it (the rows' serial rounds
// and the sort, not the arithmetic, take its time).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int FACE_TILES = 4;
constexpr int MAX_SEGS = FACE_TILES * MAX_LEVELS;
constexpr int FACE_THREADS = 64;                 // one corner each
constexpr int SKELETON_THREADS = 32;             // corner on thread 0
constexpr int MAX_BUFFER = 1024;                 // candidates a round
constexpr int LIST = 128;                        // terms a corner holds
constexpr int TERM_STACK = 9;                    // log2(LIST) + 2 levels
constexpr int CLASS_STACK = 22;                  // 2^21 classes of terms
constexpr int FEAT = 10;      // x0 x1 x2 |x|^2 n0 n1 n2 n.x 1/r^2 q
constexpr int MOMENTS = 9;
constexpr int ROW_COLS = 9;   // axis, plane, anchor a b c, 4 tiles
constexpr int POINT_COLS = 4; // x, y, z, tile (-1: outside the block)
constexpr float RADIUS_CUTOFF = 0.99f;          // kernels/mls.cl:36
constexpr unsigned long long NO_KEY = ~0ull;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  // (a0 b0 + a1 b1) + a2 b2: models/common.py::dot3
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// torch.maximum and clamp: NaN when either operand is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// Component `axis` (0 = x) of a row whose axes a, b, c are aa, aa+1,
// aa+2 (mod 3), from its components on a, b and c.
__device__ __forceinline__ float on_axis(int aa, int axis, float a, float b,
                                         float c) {
  const int rel = (axis - aa + 3) % 3;
  return rel == 0 ? a : (rel == 1 ? b : c);
}

__device__ __forceinline__ float coord(const float4& p, int axis) {
  return axis == 0 ? p.x : (axis == 1 ? p.y : p.z);
}

struct Shared {
  int start[MAX_SEGS], len[MAX_SEGS], pref[MAX_SEGS + 1];
  int nsegs, count;
  unsigned maxid;
  int passes;
  unsigned long long key[MAX_BUFFER];            // identity << 32 | entry
  float feat[FACE_THREADS][FEAT];                // one staged candidate each
  int ent[FACE_THREADS];
  unsigned char dup[FACE_THREADS];
};

// The prefix of the row's segment lengths (thread 0), after the threads
// filled start/len[0 .. nsegs).
__device__ __forceinline__ void segment_prefix(Shared& sh, int nsegs) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int i = 0; i < nsegs; ++i) {
      sh.pref[i] = acc;
      acc += sh.len[i];
    }
    sh.pref[nsegs] = acc;
    sh.nsegs = nsegs;
  }
  __syncthreads();
}

// One pass over the row's candidate slots, strided over the CTA: the
// filtered candidates with identity in (lo, hi]. With `store`, their keys
// go to sh.key (the first `cap` of them); returns how many there are and,
// in `top`, the largest identity among them.
template <int THREADS, class Keep>
__device__ int gather(Shared& sh, const float* __restrict__ entry,
                      const long long* __restrict__ vals, const Keep& keep,
                      long long lo, long long hi, int cap, bool store,
                      unsigned& top) {
  if (threadIdx.x == 0) {
    sh.count = 0;
    sh.maxid = 0;
  }
  __syncthreads();
  const int total = sh.pref[sh.nsegs];
  int si = 0, local = 0;
  unsigned mine = 0;
  for (int p = threadIdx.x; p < total; p += THREADS) {
    while (p >= sh.pref[si + 1]) ++si;
    const int e = sh.start[si] + (p - sh.pref[si]);
    const long long id = vals[e];
    const float4 a = __ldg(reinterpret_cast<const float4*>(entry + (size_t)e * 8));
    if (id <= lo || id > hi || !keep(a)) continue;
    if (store) {
      const int k = atomicAdd(&sh.count, 1);
      if (k < cap) sh.key[k] = ((unsigned long long)id << 32) | (unsigned)e;
    } else {
      ++local;
    }
    mine = max(mine, (unsigned)id);
  }
  if (local) atomicAdd(&sh.count, local);
  atomicMax(&sh.maxid, mine);
  __syncthreads();
  const int n = sh.count;
  top = sh.maxid;
  __syncthreads();
  return n;
}

// Bitonic sort of sh.key[0 .. n), padded with NO_KEY to a power of two.
template <int THREADS>
__device__ void sort_keys(Shared& sh, int n) {
  int size = 1;
  while (size < n) size <<= 1;
  for (int i = n + threadIdx.x; i < size; i += THREADS) sh.key[i] = NO_KEY;
  __syncthreads();
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < size; i += THREADS) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = sh.key[i], b = sh.key[l];
          if ((a > b) == ((i & k) == 0)) {
            sh.key[i] = b;
            sh.key[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// A corner of a row: the row's frame (global, exact integers) and the
// corner in that frame.
struct Corner {
  float fx, fy, fz, cx, cy, cz, cc;
};

// The features [x0 x1 x2 |x|^2 n0 n1 n2 n.x 1/r^2 q] of an entry row in
// the corner's frame (ops/mls.py::_features).
__device__ __forceinline__ void features(const float* __restrict__ row,
                                         const Corner& c, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));
  const float4 b = __ldg(reinterpret_cast<const float4*>(row + 4));
  const float x0 = sub(a.x, c.fx), x1 = sub(a.y, c.fy), x2 = sub(a.z, c.fz);
  f[0] = x0;
  f[1] = x1;
  f[2] = x2;
  f[3] = dot3(x0, x1, x2, x0, x1, x2);
  f[4] = b.x;
  f[5] = b.y;
  f[6] = b.z;
  f[7] = dot3(b.x, b.y, b.z, x0, x1, x2);
  f[8] = a.w;
  f[9] = b.w;
}

// A candidate's weight at the corner, and whether it is within reach
// (ops/mls.py::_weights: d = ((|x|^2 - 2 c.x) + |c|^2) / r^2).
__device__ __forceinline__ float weight(const Corner& c, const float* f,
                                        bool& hit) {
  const float dotcx = add(add(mul(c.cx, f[0]), mul(c.cy, f[1])),
                          mul(c.cz, f[2]));
  const float d = mul(add(sub(f[3], mul(2.0f, dotcx)), c.cc), f[8]);
  hit = d < RADIUS_CUTOFF;
  float w = sub(1.0f, d);
  w = mul(w, w);
  w = mul(w, w);
  return hit ? mul(w, f[9]) : 0.0f;
}

// A binary-counter stack of partial sums (design note 2): pushed leaves
// are summed as the pairwise tree of neighbouring leaves.
template <int DEPTH>
struct TreeSum {
  float stk[DEPTH][MOMENTS];
  int depth = 0;
  unsigned count = 0;

  __device__ __forceinline__ void push(float (&t)[MOMENTS]) {
    for (unsigned c = count; c & 1u; c >>= 1) {
      --depth;
#pragma unroll
      for (int j = 0; j < MOMENTS; ++j) t[j] = add(stk[depth][j], t[j]);
    }
    if (depth == DEPTH) __trap();  // more leaves than the wrapper allows
#pragma unroll
    for (int j = 0; j < MOMENTS; ++j) stk[depth][j] = t[j];
    ++depth;
    ++count;
  }

  __device__ __forceinline__ void fold(float* out) {
    float acc[MOMENTS];
#pragma unroll
    for (int j = 0; j < MOMENTS; ++j) acc[j] = depth ? stk[depth - 1][j] : 0.0f;
    for (int k = depth - 2; k >= 0; --k) {
#pragma unroll
      for (int j = 0; j < MOMENTS; ++j) acc[j] = add(stk[k][j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < MOMENTS; ++j) out[j] = acc[j];
  }
};

// i with its low `bits` bits reversed.
__device__ __forceinline__ unsigned reverse(unsigned i, int bits) {
  return bits ? __brev(i) >> (32 - bits) : 0u;
}

// The halves tree of ops/mls.py::_tree_sum over 2^bits leaves: the terms
// [1, x, |x|^2, n, n.x] * w of the entries list[0 .. s) at the corner,
// zeros after them. It is the tree of neighbouring leaves over the leaves
// in bit-reversed order, which the stack builds.
__device__ void halves_tree(const int* list, int s, int bits,
                            const float* __restrict__ entry, const Corner& c,
                            float* out) {
  TreeSum<TERM_STACK> tree;
  for (unsigned j = 0; j < (1u << bits); ++j) {
    const unsigned i = reverse(j, bits);
    float t[MOMENTS] = {};
    if (i < (unsigned)s) {
      float f[FEAT];
      features(entry + (size_t)list[i] * 8, c, f);
      bool hit;
      const float w = weight(c, f, hit);
      t[0] = w;
#pragma unroll
      for (int k = 0; k < MOMENTS - 1; ++k) t[k + 1] = mul(f[k], w);
    }
    tree.push(t);
  }
  tree.fold(out);
}

// Every candidate of the row once, repeats skipped, in ascending identity:
// visit(features, entry) on the threads with `active`, round by round
// (design note 1). All threads of the CTA call it.
template <int THREADS, class Keep, class Visit>
__device__ void stream(Shared& sh, const float* __restrict__ entry,
                       const long long* __restrict__ vals, const Keep& keep,
                       const Corner& c, bool active, int cap, Visit& visit) {
  long long prev = -1;             // identities <= prev are done
  bool more = sh.pref[sh.nsegs] > 0;
  while (more) {
    long long hi = 0x7fffffffffffffffll;
    unsigned top = 0;
    int n = gather<THREADS>(sh, entry, vals, keep, prev, hi, cap, true, top);
    if (n > cap) {
      // count(prev, lo] <= cap < count(prev, up]
      long long lo = prev, up = top;
      while (up - lo > 1) {
        const long long mid = lo + (up - lo) / 2;
        if (gather<THREADS>(sh, entry, vals, keep, prev, mid, cap, false,
                            top) <= cap)
          lo = mid;
        else
          up = mid;
      }
      if (lo == prev) __trap();    // one identity listed > cap times
      hi = lo;
      n = gather<THREADS>(sh, entry, vals, keep, prev, hi, cap, true, top);
    } else {
      more = false;
    }
    prev = hi;
    sort_keys<THREADS>(sh, n);

    for (int k0 = 0; k0 < n; k0 += THREADS) {
      const int k = k0 + threadIdx.x;
      if (k < n) {
        const unsigned long long key = sh.key[k];
        const int e = (int)(unsigned)(key & 0xffffffffu);
        features(entry + (size_t)e * 8, c, sh.feat[threadIdx.x]);
        sh.ent[threadIdx.x] = e;
        sh.dup[threadIdx.x] = k > 0 && (sh.key[k - 1] >> 32) == (key >> 32);
      }
      __syncthreads();
      if (active) {
        const int m = min(THREADS, n - k0);
        for (int i = 0; i < m; ++i)
          if (!sh.dup[i]) visit(sh.feat[i], sh.ent[i]);
      }
      __syncthreads();
    }
  }
}

// The moments and hits of one row's corners (the thread of corner `c`
// when `corner`), after the row's segments are in sh. A corner holds the
// entries of up to `lcap` (a power of two) nonzero-weight candidates; one
// stream counts its hits and terms and keeps the first lcap; with more
// terms, the ranks fall in 2^cbits classes of residues, each of at most
// lcap, one stream each: the halves tree of the terms is the halves tree
// of the classes' own trees, taken in bit-reversed order of the residue.
template <int THREADS, class Keep>
__device__ void row_moments(Shared& sh, const float* __restrict__ entry,
                            const long long* __restrict__ vals,
                            const Keep& keep, const Corner& c, bool corner,
                            int cap, int lcap, float* __restrict__ m_out,
                            int* __restrict__ hits_out) {
  int list[LIST];
  int n = 0, hits = 0;
  auto first = [&](const float* f, int e) {
    bool hit;
    const float w = weight(c, f, hit);
    hits += hit;
    if (!(w == 0.0f)) {            // nonzero (or NaN) weight: a term
      if (n < lcap) list[n] = e;
      ++n;
    }
  };
  stream<THREADS>(sh, entry, vals, keep, c, corner, cap, first);

  const int bits = n > 1 ? 32 - __clz(n - 1) : 0;   // 2^bits >= n leaves
  const int lbits = 31 - __clz(lcap);
  const int cbits = n > lcap ? bits - lbits : 0;
  float m[MOMENTS];
  if (corner && !cbits) halves_tree(list, n, bits, entry, c, m);
  if (threadIdx.x == 0) sh.passes = 0;
  __syncthreads();
  if (corner && cbits) atomicMax(&sh.passes, 1 << cbits);
  __syncthreads();
  const int passes = sh.passes;
  if (passes) {
    TreeSum<CLASS_STACK> classes;
    for (int p = 0; p < passes; ++p) {
      const bool mine = corner && cbits && p < (1 << cbits);
      const unsigned r = reverse(p, cbits);
      const unsigned mask = (1u << cbits) - 1u;
      unsigned rank = 0;
      int s = 0;
      auto collect = [&](const float* f, int e) {
        bool hit;
        if (!(weight(c, f, hit) == 0.0f)) {
          if ((rank & mask) == r) list[s++] = e;
          ++rank;
        }
      };
      stream<THREADS>(sh, entry, vals, keep, c, mine, cap, collect);
      if (mine) {
        float t[MOMENTS];
        halves_tree(list, s, lbits, entry, c, t);
        classes.push(t);
      }
    }
    if (corner && cbits) classes.fold(m);
  }
  if (corner) {
#pragma unroll
    for (int j = 0; j < MOMENTS; ++j) m_out[j] = m[j];
    *hits_out = hits;
  }
}

struct FaceKeep {        // the exact splat-to-patch-rectangle test
  int aa;
  float plane, b0, c0;
  __device__ __forceinline__ bool operator()(const float4& p) const {
    const float da = sub(coord(p, aa), plane);
    const float pb = coord(p, (aa + 1) % 3), pc = coord(p, (aa + 2) % 3);
    const float db = nan_max(nan_max(sub(b0, pb), sub(pb, add(b0, 7.0f))), 0.0f);
    const float dc = nan_max(nan_max(sub(c0, pc), sub(pc, add(c0, 7.0f))), 0.0f);
    const float rect2 = add(add(mul(da, da), mul(db, db)), mul(dc, dc));
    return mul(rect2, p.w) < RADIUS_CUTOFF;
  }
};

struct PointKeep {       // the point's own positive-weight test
  float px, py, pz;
  __device__ __forceinline__ bool operator()(const float4& p) const {
    const float dx = sub(p.x, px), dy = sub(p.y, py), dz = sub(p.z, pz);
    return mul(dot3(dx, dy, dz, dx, dy, dz), p.w) < RADIUS_CUTOFF;
  }
};

// One CTA per face patch row (mls.py::face_rows); thread t is corner t at
// b = t / 8, c = t % 8 of the patch, on the face's plane.
__global__ void __launch_bounds__(FACE_THREADS)
seam_face_kernel(const float* __restrict__ entry,          // (E, 8)
                 const long long* __restrict__ vals,       // (E,)
                 const int* __restrict__ seg_starts,       // (T, L)
                 const int* __restrict__ seg_lens,         // (T, L)
                 int levels, const int* __restrict__ rows, // (R, ROW_COLS)
                 int cap, float* __restrict__ moments,     // (R, 64, 9)
                 int* __restrict__ hits) {                 // (R, 64)
  __shared__ Shared sh;
  const int* row = rows + (size_t)blockIdx.x * ROW_COLS;
  const int aa = row[0], plane = row[1], base_a = row[2];
  const int base_b = row[3], base_c = row[4];
  const int t = threadIdx.x;
  const int nsegs = FACE_TILES * levels;
  if (t < nsegs) {         // the level segments of the distinct tiles
    const int j = t / levels, l = t % levels;
    const int tile = row[5 + j];
    bool repeat = false;
    for (int i = 0; i < j; ++i) repeat |= row[5 + i] == tile;
    sh.start[t] = repeat ? 0 : seg_starts[(size_t)tile * levels + l];
    sh.len[t] = repeat ? 0 : seg_lens[(size_t)tile * levels + l];
  }
  segment_prefix(sh, nsegs);
  const float fa = (float)base_a, fb = (float)base_b, fc = (float)base_c;
  const float ca = (float)(plane - base_a), cb = (float)(t / 8),
              cc = (float)(t % 8);
  Corner c{on_axis(aa, 0, fa, fb, fc), on_axis(aa, 1, fa, fb, fc),
           on_axis(aa, 2, fa, fb, fc), on_axis(aa, 0, ca, cb, cc),
           on_axis(aa, 1, ca, cb, cc), on_axis(aa, 2, ca, cb, cc), 0.0f};
  c.cc = dot3(c.cx, c.cy, c.cz, c.cx, c.cy, c.cz);
  const FaceKeep keep{aa, (float)plane, fb, fc};
  const size_t at = (size_t)blockIdx.x * FACE_THREADS + t;
  row_moments<FACE_THREADS>(sh, entry, vals, keep, c, true, cap,
                            min(cap, LIST), moments + at * MOMENTS,
                            hits + at);
}

// One CTA per skeleton point; thread 0 holds the corner.
__global__ void __launch_bounds__(SKELETON_THREADS)
seam_skeleton_kernel(const float* __restrict__ entry,
                     const long long* __restrict__ vals,
                     const int* __restrict__ seg_starts,
                     const int* __restrict__ seg_lens, int levels,
                     const int* __restrict__ points,   // (P, POINT_COLS)
                     int cap, float* __restrict__ moments,  // (P, 1, 9)
                     int* __restrict__ hits) {              // (P, 1)
  __shared__ Shared sh;
  const int* pt = points + (size_t)blockIdx.x * POINT_COLS;
  const int tile = pt[3];
  const int t = threadIdx.x;
  if (t < levels) {
    sh.start[t] = tile < 0 ? 0 : seg_starts[(size_t)tile * levels + t];
    sh.len[t] = tile < 0 ? 0 : seg_lens[(size_t)tile * levels + t];
  }
  segment_prefix(sh, levels);
  // the frame: the global 8-aligned cube holding the point
  const int bx = pt[0] - (((pt[0] % 8) + 8) % 8);
  const int by = pt[1] - (((pt[1] % 8) + 8) % 8);
  const int bz = pt[2] - (((pt[2] % 8) + 8) % 8);
  Corner c{(float)bx, (float)by, (float)bz, (float)(pt[0] - bx),
           (float)(pt[1] - by), (float)(pt[2] - bz), 0.0f};
  c.cc = dot3(c.cx, c.cy, c.cz, c.cx, c.cy, c.cz);
  const PointKeep keep{(float)pt[0], (float)pt[1], (float)pt[2]};
  row_moments<SKELETON_THREADS>(sh, entry, vals, keep, c, t == 0, cap,
                                min(cap, LIST),
                                moments + (size_t)blockIdx.x * MOMENTS,
                                hits + blockIdx.x);
}

int check_args(int levels, int cap) {
  if (levels < 1 || levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  if (cap < FACE_TILES || cap > MAX_BUFFER || (cap & (cap - 1)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// C entry points. Each launches on `stream` without synchronising and
// returns the launch's cudaError_t (0 = queued). `cap` is the candidate
// buffer of a round: a power of two in [4, seam_max_buffer()]; a corner
// holds min(cap, seam_max_terms()) terms at once. Smaller ones only run
// more rounds and streams; a corner may have at most 2^(CLASS_STACK - 1)
// times that many terms (seam_max_terms_factor()).
extern "C" int seam_max_buffer() { return MAX_BUFFER; }
extern "C" int seam_max_terms() { return LIST; }
extern "C" int seam_max_terms_factor() { return 1 << (CLASS_STACK - 1); }

// seam_face_launch: moments (R, 64, 9) f32 and hits (R, 64) int32 of
// every face patch row; rows (R, 9) int32 as mls.py::face_rows.
extern "C" int seam_face_launch(const float* entry, const long long* vals,
                                const int* seg_starts, const int* seg_lens,
                                int levels, const int* rows, int num_rows,
                                int cap, float* moments, int* hits,
                                void* stream) {
  const int bad = check_args(levels, cap);
  if (bad) return bad;
  if (num_rows == 0) return 0;
  seam_face_kernel<<<num_rows, FACE_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      entry, vals, seg_starts, seg_lens, levels, rows, cap, moments, hits);
  return (int)cudaGetLastError();
}

// seam_skeleton_launch: moments (P, 1, 9) f32 and hits (P, 1) int32 of
// every skeleton point; points (P, 4) int32: x, y, z global and the tile
// holding the point, -1 for a point outside the block (zeros).
extern "C" int seam_skeleton_launch(const float* entry, const long long* vals,
                                    const int* seg_starts,
                                    const int* seg_lens, int levels,
                                    const int* points, int num_points,
                                    int cap, float* moments, int* hits,
                                    void* stream) {
  const int bad = check_args(levels, cap);
  if (bad) return bad;
  if (num_points == 0) return 0;
  seam_skeleton_kernel<<<num_points, SKELETON_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      entry, vals, seg_starts, seg_lens, levels, points, cap, moments, hits);
  return (int)cudaGetLastError();
}
