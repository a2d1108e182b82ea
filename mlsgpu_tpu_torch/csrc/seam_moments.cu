// The seam passes as whole passes, one launch each per block: the face
// kernel (every corner of every face patch row: moments, fit, and the
// write into the field) and the skeleton kernel (every decomposition-edge
// skeleton point: the same at the point's own corner).
//
// They stand for stages the JAX package compiles with XLA, each pass
// into one program: mlsgpu_tpu/ops/mls.py::canonical_face_field (:188)
// and ::skeleton_point_field (:492), jitted at
// mlsgpu_tpu/ops/block.py:636-645. Their plain PyTorch versions are
// mlsgpu_tpu_torch/ops/mls.py::canonical_face_field and
// ::skeleton_point_field (face_rows / skeleton_points, face_moments /
// skeleton_moments, then _fit with models/ and write_faces /
// fit_points), which the kernels equal bit for bit. ops/mls_cuda.py
// builds this file with mls_field.cu into one library; ops/seam_cuda.py
// calls the C entry points below through ctypes, on PyTorch's current
// stream, without synchronising.
//
// What an item (a face patch row or a skeleton point) computes:
//   * the row from blockIdx-derived row ids and the block's scalars, with
//     face_rows' arithmetic (the point: its block-local coords, tile and
//     inside test, with skeleton_points' arithmetic): no host array;
//   * its candidates are the level segments of its covering tiles (the
//     <= 4 distinct tiles of a face row, the one tile of a point), walked
//     in full, filtered by the exact splat-to-rectangle test of a face row
//     (rect2 * 1/r^2 < 0.99) or the point's own distance test, repeats of
//     one splat identity (entry_vals) dropped, taken in ascending
//     identity, the stream order;
//   * each corner sums the terms [1, x, |x|^2, n, n.x] * w of the
//     candidates of nonzero weight w = (1-d)^4 q there, in that order, as
//     ops/mls.py::_tree_sum's halves tree over the terms padded with +0.0
//     to a power of two P, and counts the candidates with d < 0.99
//     (hits);
//   * the fit (ops/mls.py::_fit, models/sphere.py or models/plane.py,
//     models/common.py) and the write: each field corner of the six face
//     planes by exactly one row, the row of the last face in
//     write_faces' order (x-, x+, y-, y+, z-, z+) that covers it, rows
//     without candidates writing NaN; a skeleton point writes its corner
//     when it lies inside the block. A moments mode writes the moments
//     (N, corners, 9) and hits (N, corners) instead of the field (zeros
//     for an item without candidates, as the plain versions give).
//
// Design:
//   1. Work items. A face CTA of 8 warps takes one batch of 8 rows, S =
//      rows / 8 apart (occupied rows cluster in row order, so the stride
//      spreads them over CTAs). Each warp reads one row's segment
//      lengths; a row without candidates is written (NaN) by that warp at
//      once, so the rows that are empty (~92% at the densest 256^3 bucket
//      of the 2M bench cloud) cost one coalesced read and a write. Then
//      the CTA runs the batch's occupied rows one after the other. No CTA
//      waits on another, so launches on several streams of one card at
//      once can share it in any proportion. Skeleton CTAs are 8 warps, a
//      point a warp, a CTA a batch of 8 points.
//   2. Staging. A group (the CTA for a row, the warp for a point)
//      gathers the filtered candidates (a warp ballot and one shared
//      atomic per warp hand out slots; the order of arrival does not
//      matter), sorts the keys identity << 32 | entry (by counting ranks
//      when they fit one per thread, else bitonic), drops repeated
//      identities (a group scan gives each kept candidate its rank) and
//      stages the kept candidates' features in the item's frame once, in
//      shared memory (10 f32 each, struct of arrays). A row whose
//      candidates overflow the buffer walks identity windows that fit,
//      found by a binary search over identities (a splat sits
//      at most once in a tile's chain, so at most 4 times in a row, and
//      any buffer of >= 4 makes progress); their bounds are remembered,
//      so later streams of the row gather each window once.
//   3. The halves tree on a warp. A corner belongs to one warp. Its P
//      leaves split into G = max(1, P / 32) residue classes of rank
//      (class p: ranks p, p + G, ..., p + 31 G): the halves tree of the
//      leaves is the halves tree of the classes' own trees in class
//      order, each class's tree being that of its 32 leaves in order. So
//      a class is one leaf a lane (lane l: rank p + G l), reduced by
//      __shfl_down_sync with offsets 16, 8, 4, 2, 1 (P < 32: P/2 ... 1,
//      lanes >= P out, holding +0.0); and the classes, taken in
//      bit-reversed order, are summed as neighbours by a binary-counter
//      stack of partial sums that lives one level a lane (32 levels: up
//      to 2^31 classes). A lane finds its leaf in a stream over the staged
//      candidates: per chunk of 32, a ballot of the nonzero weights
//      gives the chunk's ranks, and the lane holding rank p + G l (the
//      l-th set bit, by popc) hands the term over by shuffle. The corner's
//      first stream counts its terms and hits and takes ranks 0-31, the
//      one class of a corner with at most 32 terms; a corner with more
//      runs G streams more, one a class. No list or stack lives in local
//      memory, and nothing re-reads device memory while the row fits the
//      buffer (with the default buffer, every row of the 2M bench cloud
//      does). A row that overflows runs a counting stream over its
//      windows, then its corners eight at a time (one a warp), G streams
//      each.
//   4. No contraction: every product, sum, quotient and root is __fmul_rn
//      / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn in the plain
//      version's order (models/common.py::dot3 is (a0 b0 + a1 b1) + a2
//      b2; `1.0 / sum_w` a correctly rounded quotient, as torch's
//      reciprocal; the instability threshold (4 FLT_EPSILON) * hits *
//      |sum_wpp| left to right with 4 FLT_EPSILON as the f32 2^-21 and
//      hits converted to f32; the boundary factor as the f32 torch's
//      scalar becomes), so every value equals the plain pass's bit for
//      bit, on the card and on the CPU (tests/test_torch_seam_epilogue.py
//      holds a numpy transcription of the fit to ops/mls.py::_fit).
//
// The bound (chip_smoke.py seam_bound, from mls.face_work and
// skeleton_work on each run's inputs): every listed candidate's filter
// columns (16 bytes) and identity (8 bytes) read once, every kept
// candidate's row (32 bytes) read once, the field corners written (4
// bytes each); the filter's, the moments' and the fit's FP32 operations.
// At the densest 256^3 bucket both come to about a microsecond, bytes
// first. The kernel is bound instead by latency: an occupied row is a
// chain of dependent steps (its segment reads, gather, sort and staging,
// each a round trip to memory or a few CTA barriers, then its corners'
// streams, a warp running 8 corners one after the other, then the fit),
// and the kernel lasts about as long as its slowest CTA, the one whose
// batch holds the rows with the most candidates (PERF.md section 6).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int FACE_TILES = 4;
constexpr int MAX_SEGS = FACE_TILES * MAX_LEVELS;
constexpr int WARP = 32;
constexpr int WARPS = 8;                        // warps of a CTA
constexpr int THREADS = WARPS * WARP;
constexpr int ROW_CORNERS = 64;                 // an 8x8 patch
constexpr int MAX_BUFFER = 1024;     // a row's window: candidates with repeats
constexpr int POINT_BUFFER = 128;    // a point's window (a warp's)
constexpr int MAX_WINDOWS = 32;      // window bounds an item remembers
constexpr int FEAT = 10;      // x0 x1 x2 |x|^2 n0 n1 n2 n.x 1/r^2 q
constexpr int MOMENTS = 9;
constexpr float RADIUS_CUTOFF = 0.99f;          // kernels/mls.cl:36
constexpr int HITS_CUTOFF = 4;                  // kernels/mls.cl:37
// (4 * FLT_EPSILON) of models/sphere.py as torch's f32 scalar: 2^-21
constexpr float EPS4 = 4.76837158203125e-07f;
constexpr unsigned long long NO_KEY = ~0ull;
constexpr long long NO_ID = LLONG_MAX;          // the window without end
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  // (a0 b0 + a1 b1) + a2 b2: models/common.py::dot3
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

__device__ __forceinline__ float dot3(const float (&a)[3], const float (&b)[3]) {
  return dot3(a[0], a[1], a[2], b[0], b[1], b[2]);
}

// torch.maximum and clamp: NaN when either operand is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}

// Element i of (v0, v1, v2), without an indexed array (which would live in
// local memory).
template <class T>
__device__ __forceinline__ T pick3(T v0, T v1, T v2, int i) {
  return i == 0 ? v0 : (i == 1 ? v1 : v2);
}

__device__ __forceinline__ float coord(const float4& p, int axis) {
  return pick3(p.x, p.y, p.z, axis);
}

__device__ __forceinline__ unsigned pow2(unsigned n) {
  return n <= 1 ? 1u : 1u << (32 - __clz(n - 1));
}

__device__ __forceinline__ int log2u(unsigned v) { return 31 - __clz(v); }

// s with its low `bits` bits reversed.
__device__ __forceinline__ unsigned reverse(unsigned s, int bits) {
  return bits ? __brev(s) >> (32 - bits) : 0u;
}

// The classes of a corner with P leaves (design note 3).
__device__ __forceinline__ unsigned classes(unsigned P) {
  return P > WARP ? P / WARP : 1u;
}

// The position of the n-th (from 0) set bit of m.
__device__ __forceinline__ int nth_set(unsigned m, unsigned n) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const unsigned c = __popc(m & ((1u << s) - 1u));
    if (n >= c) {
      n -= c;
      m >>= s;
      pos += s;
    }
  }
  return pos;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & (WARP - 1); }

// --- groups: the CTA (a face row) or a warp (a skeleton point) -------------

struct Cta {
  static constexpr int SIZE = THREADS;
  __device__ static int rank() { return threadIdx.x; }
  __device__ static void sync() { __syncthreads(); }
};

struct Warp {
  static constexpr int SIZE = WARP;
  __device__ static int rank() { return lane_id(); }
  __device__ static void sync() { __syncwarp(); }
};

// An item's candidate list and its group's scratch, in shared memory.
template <int N>
struct Item {
  int start[N], len[N], pref[N + 1];
  int nsegs, count;
  unsigned maxid;
  int red[WARPS];
  int nwin;                              // remembered window bounds
  long long win_hi[MAX_WINDOWS];
};

// Everything a launch passes (by value: the kernels' parameter space).
struct Args {
  const float* entry;          // (E, 8) f32: x y z 1/r^2 nx ny nz q
  const long long* vals;       // (E,) splat identity
  const int* seg_starts;       // (T, L)
  const int* seg_lens;         // (T, L)
  int levels, tpa, cap;
  int ox, oy, oz;              // the block's cell origin
  int rx, ry, rz;              // its region cells (face pass)
  const long long* points;     // (P, 3) global corners (skeleton pass)
  int num_points;
  int plane;                   // 0: sphere fit, 1: plane fit
  float bf;                    // boundary factor
  float* field;                // (B, B, B) [z, y, x], or null: moments mode
  float* moments;              // (N, corners, 9)
  int* hits;                   // (N, corners)
};

// The prefix of the item's segment lengths (a scan on the group's first
// warp, two segments a lane), after the group filled start/len[0 ..
// nsegs).
template <class G, int N>
__device__ __forceinline__ void segment_prefix(Item<N>& it, int nsegs) {
  static_assert(N <= 2 * WARP, "two segments a lane");
  G::sync();
  if (G::rank() < WARP) {
    const int lane = lane_id(), i = 2 * lane;
    const int a = i < nsegs ? it.len[i] : 0;
    const int b = i + 1 < nsegs ? it.len[i + 1] : 0;
    int x = a + b;
#pragma unroll
    for (int o = 1; o < WARP; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    const int total = __shfl_sync(FULL, x, WARP - 1);
    if (i < nsegs) it.pref[i] = x - a - b;
    if (i + 1 < nsegs) it.pref[i + 1] = x - b;
    if (lane == 0) {
      it.pref[nsegs] = total;
      it.nsegs = nsegs;
      it.nwin = 0;
    }
  }
  G::sync();
}

// Exclusive prefix of v over the group (rank order); `total` the sum.
template <class G, int N>
__device__ int group_scan(Item<N>& it, int v, int& total) {
  const int lane = lane_id();
  int x = v;
#pragma unroll
  for (int o = 1; o < WARP; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  const int excl = x - v;
  const int wtot = __shfl_sync(FULL, x, WARP - 1);
  if (G::SIZE == WARP) {
    total = wtot;
    return excl;
  }
  const int w = G::rank() / WARP;
  if (lane == 0) it.red[w] = wtot;
  G::sync();
  int off = 0, tot = 0;
  for (int i = 0; i < G::SIZE / WARP; ++i) {
    off += i < w ? it.red[i] : 0;
    tot += it.red[i];
  }
  G::sync();
  total = tot;
  return off + excl;
}

// One pass over the item's candidate slots, strided over the group: the
// filtered candidates with identity in (lo, hi]. With `store`, their keys
// go to key (the first `cap` of them); returns how many there are and, in
// `top`, the largest identity among them.
template <class G, int N, class Keep>
__device__ int gather(Item<N>& it, unsigned long long* key, int cap,
                      const Args& a, const Keep& keep, long long lo,
                      long long hi, bool store, unsigned& top) {
  const int lane = lane_id();
  if (G::rank() == 0) {
    it.count = 0;
    it.maxid = 0;
  }
  G::sync();
  const int total = it.pref[it.nsegs];
  int si = 0, local = 0;
  unsigned mine = 0;
  for (int p0 = 0; p0 < total; p0 += G::SIZE) {
    const int p = p0 + G::rank();
    bool ok = false;
    long long id = 0;
    int e = 0;
    if (p < total) {
      while (p >= it.pref[si + 1]) ++si;
      e = it.start[si] + (p - it.pref[si]);
      id = __ldg(a.vals + e);
      const float4 c = __ldg(reinterpret_cast<const float4*>(a.entry + (size_t)e * 8));
      ok = id > lo && id <= hi && keep(c);
      if (ok) mine = max(mine, (unsigned)id);
    }
    if (store) {
      const unsigned bal = __ballot_sync(FULL, ok);
      int base = 0;
      if (lane == 0 && bal) base = atomicAdd(&it.count, __popc(bal));
      base = __shfl_sync(FULL, base, 0);
      const int slot = base + __popc(bal & ((1u << lane) - 1u));
      if (ok && slot < cap)
        key[slot] = ((unsigned long long)id << 32) | (unsigned)e;
    } else {
      local += ok;
    }
  }
  if (!store) {
    local = __reduce_add_sync(FULL, local);
    if (lane == 0 && local) atomicAdd(&it.count, local);
  }
  mine = __reduce_max_sync(FULL, mine);
  if (lane == 0 && mine) atomicMax(&it.maxid, mine);
  G::sync();
  const int n = it.count;
  top = it.maxid;
  G::sync();
  return n;
}

// Window w of the item, the filtered candidates with identity in (prev,
// hi], at most cap of them, gathered into key; returns their count and
// sets hi (NO_ID for the last window). Bounds found once are remembered.
template <class G, int N, class Keep>
__device__ int next_window(Item<N>& it, unsigned long long* key, int cap,
                           const Args& a, const Keep& keep, long long prev,
                           int w, long long& hi) {
  unsigned top;
  if (w < it.nwin) {
    hi = it.win_hi[w];
    return gather<G>(it, key, cap, a, keep, prev, hi, true, top);
  }
  hi = NO_ID;
  int n = gather<G>(it, key, cap, a, keep, prev, hi, true, top);
  if (n > cap) {
    // count(prev, lo] <= cap < count(prev, up]
    long long lo = prev, up = top;
    while (up - lo > 1) {
      const long long mid = lo + (up - lo) / 2;
      if (gather<G>(it, key, cap, a, keep, prev, mid, false, top) <= cap)
        lo = mid;
      else
        up = mid;
    }
    if (lo == prev) __trap();      // one identity listed > cap times
    hi = lo;
    n = gather<G>(it, key, cap, a, keep, prev, hi, true, top);
  }
  if (G::rank() == 0 && w == it.nwin && w < MAX_WINDOWS) {
    it.win_hi[w] = hi;
    it.nwin = w + 1;
  }
  G::sync();
  return n;
}

// Bitonic sort of key[0 .. n), padded with NO_KEY to a power of two.
template <class G>
__device__ void bitonic(unsigned long long* key, int n) {
  int size = 1;
  while (size < n) size <<= 1;
  for (int i = n + G::rank(); i < size; i += G::SIZE) key[i] = NO_KEY;
  G::sync();
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = G::rank(); i < size; i += G::SIZE) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long x = key[i], y = key[l];
          if ((x > y) == ((i & k) == 0)) {
            key[i] = y;
            key[l] = x;
          }
        }
      }
      G::sync();
    }
  }
}

// An item's frame: its multiple-of-8 global anchor (exact integers).
struct Frame {
  float x, y, z;
};

// Sort the window's m keys, drop repeated identities, and stage the kept
// candidates' features [x0 x1 x2 |x|^2 n0 n1 n2 n.x 1/r^2 q] in the frame
// (ops/mls.py::_features) at their ranks: feat[j * cap + k]. Returns the
// number kept.
template <class G, int N>
__device__ int stage(Item<N>& it, unsigned long long* key, float* feat,
                     int cap, int m, const Args& a, const Frame& f) {
  const int r = G::rank();
  if (m <= G::SIZE) {
    // counting ranks, ties by position: two tiles of a row can share a
    // coarse node's segment, and so list one entry twice
    const unsigned long long k = r < m ? key[r] : NO_KEY;
    int rank = 0;
    if (r < m)
      for (int j = 0; j < m; ++j) rank += key[j] < k || (key[j] == k && j < r);
    G::sync();
    if (r < m) key[rank] = k;
    G::sync();
  } else {
    bitonic<G>(key, m);
  }
  const int per = (m + G::SIZE - 1) / G::SIZE;
  const int i0 = min(r * per, m), i1 = min(i0 + per, m);
  int firsts = 0;
  for (int i = i0; i < i1; ++i)
    firsts += i == 0 || (key[i - 1] >> 32) != (key[i] >> 32);
  int kept;
  int u = group_scan<G>(it, firsts, kept);
  for (int i = i0; i < i1; ++i) {
    if (i > 0 && (key[i - 1] >> 32) == (key[i] >> 32)) continue;
    const float* row = a.entry + (size_t)(unsigned)(key[i] & 0xffffffffu) * 8;
    const float4 p = __ldg(reinterpret_cast<const float4*>(row));
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + 4));
    const float x0 = sub(p.x, f.x), x1 = sub(p.y, f.y), x2 = sub(p.z, f.z);
    feat[u] = x0;
    feat[cap + u] = x1;
    feat[2 * cap + u] = x2;
    feat[3 * cap + u] = dot3(x0, x1, x2, x0, x1, x2);
    feat[4 * cap + u] = q.x;
    feat[5 * cap + u] = q.y;
    feat[6 * cap + u] = q.z;
    feat[7 * cap + u] = dot3(q.x, q.y, q.z, x0, x1, x2);
    feat[8 * cap + u] = p.w;
    feat[9 * cap + u] = q.w;
    ++u;
  }
  G::sync();
  return kept;
}

// --- a corner's moments on its warp (design note 3) -------------------------

// A corner in its item's frame.
struct Corner {
  float x, y, z, cc;
};

__device__ __forceinline__ Corner make_corner(float x, float y, float z) {
  return Corner{x, y, z, dot3(x, y, z, x, y, z)};
}

// Candidate k's weight at the corner and whether it is within reach
// (ops/mls.py::_weights: d = ((|x|^2 - 2 c.x) + |c|^2) / r^2).
__device__ __forceinline__ float weight(const float* feat, int cap, int k,
                                        const Corner& c, bool& hit) {
  const float dotcx = add(add(mul(c.x, feat[k]), mul(c.y, feat[cap + k])),
                          mul(c.z, feat[2 * cap + k]));
  const float d = mul(add(sub(feat[3 * cap + k], mul(2.0f, dotcx)), c.cc),
                      feat[8 * cap + k]);
  hit = d < RADIUS_CUTOFF;
  float w = sub(1.0f, d);
  w = mul(w, w);
  w = mul(w, w);
  return hit ? mul(w, feat[9 * cap + k]) : 0.0f;
}

// One class of a corner's leaves: ranks p + G l, lane l's leaf.
struct Class {
  unsigned p, G, r0;                   // r0: terms of the windows before
  float leaf[MOMENTS];
};

// Stream the window's candidates; the lane whose rank lies here takes its
// term ([1, x, |x|^2, n, n.x] * w, ops/mls.py::_canonical_sums) from the
// lane that computed it. With HITS, also count the hits into `hits`.
template <bool HITS>
__device__ void class_scan(const float* feat, int cap, int K, const Corner& c,
                           Class& cl, unsigned& hits) {
  const int lane = lane_id();
  const unsigned want = cl.p + cl.G * (unsigned)lane;
  for (int k0 = 0; k0 < K; k0 += WARP) {
    const int k = k0 + lane;
    bool hit = false;
    const float w = k < K ? weight(feat, cap, k, c, hit) : 0.0f;
    const bool term = k < K && !(w == 0.0f);
    const unsigned bal = __ballot_sync(FULL, term);
    const unsigned cnt = __popc(bal);
    if (HITS) hits += __popc(__ballot_sync(FULL, hit));
    const bool in = want >= cl.r0 && want - cl.r0 < cnt;
    if (__any_sync(FULL, in)) {
      const int src = in ? nth_set(bal, want - cl.r0) : lane;
      float t[MOMENTS];
      t[0] = w;
#pragma unroll
      for (int j = 0; j < MOMENTS - 1; ++j)
        t[j + 1] = term ? mul(feat[j * cap + k], w) : 0.0f;
#pragma unroll
      for (int j = 0; j < MOMENTS; ++j) {
        const float v = __shfl_sync(FULL, t[j], src);
        if (in) cl.leaf[j] = v;
      }
    }
    cl.r0 += cnt;
  }
}

// The class's halves tree over its lanes: offsets 16 ... 1 (P < 32: P/2
// ... 1); lane 0 holds it.
__device__ __forceinline__ void class_reduce(Class& cl, unsigned P) {
  for (unsigned off = P >= WARP ? WARP / 2 : P / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < MOMENTS; ++j)
      cl.leaf[j] = add(cl.leaf[j], __shfl_down_sync(FULL, cl.leaf[j], off));
  }
}

// Push the s-th class sum (lane 0's leaf) onto the binary-counter stack
// whose level d lives on lane d: left + right while the two top blocks
// have equal size.
__device__ __forceinline__ void push(float (&part)[MOMENTS],
                                     const float (&leaf)[MOMENTS],
                                     unsigned s) {
  float v[MOMENTS];
#pragma unroll
  for (int j = 0; j < MOMENTS; ++j) v[j] = __shfl_sync(FULL, leaf[j], 0);
  int d = 0;
  for (unsigned c = s; c & 1u; c >>= 1, ++d) {
#pragma unroll
    for (int j = 0; j < MOMENTS; ++j)
      v[j] = add(__shfl_sync(FULL, part[j], d), v[j]);
  }
  if (lane_id() == d) {
#pragma unroll
    for (int j = 0; j < MOMENTS; ++j) part[j] = v[j];
  }
}

__device__ __forceinline__ void clear(float (&v)[MOMENTS]) {
#pragma unroll
  for (int j = 0; j < MOMENTS; ++j) v[j] = 0.0f;
}

// The corner's moments (all lanes) and hits when the item's candidates
// are all staged (one window of K). The first stream counts the terms and
// hits and gathers ranks 0-31, the one class of a corner with at most 32
// terms, the most common; a corner with more runs a stream a class.
__device__ void resident_corner(const float* feat, int cap, int K,
                                const Corner& c, float (&m)[MOMENTS],
                                unsigned& hits) {
  hits = 0;
  Class cl;
  cl.p = 0;
  cl.G = 1;
  cl.r0 = 0;
  clear(cl.leaf);
  class_scan<true>(feat, cap, K, c, cl, hits);
  const unsigned P = pow2(cl.r0), G = classes(P);
  const int lg = log2u(G);
  float part[MOMENTS];
  for (unsigned s = 0; s < G && G > 1; ++s) {
    cl.p = reverse(s, lg);
    cl.G = G;
    cl.r0 = 0;
    clear(cl.leaf);
    class_scan<false>(feat, cap, K, c, cl, hits);
    class_reduce(cl, P);
    push(part, cl.leaf, s);
  }
  if (G == 1) class_reduce(cl, P);
#pragma unroll
  for (int j = 0; j < MOMENTS; ++j)
    m[j] = __shfl_sync(FULL, G > 1 ? part[j] : cl.leaf[j], G > 1 ? lg : 0);
}

// The moments and hits of an item's NC corners into mom / hits (shared
// memory; nterm: scratch), its segments in `it`. corner_at(c): corner c
// in the frame; corner c belongs to warp c % (G::SIZE / 32) of the group.
template <class G, int N, int NC, class Keep, class CornerAt>
__device__ void item_moments(Item<N>& it, unsigned long long* key,
                             float* feat, int cap, const Args& a,
                             const Keep& keep, const Frame& fr,
                             const CornerAt& corner_at,
                             float (*mom)[MOMENTS], int* hits,
                             unsigned* nterm) {
  constexpr int NW = G::SIZE / WARP;
  const int wg = G::rank() / WARP, lane = lane_id();
  long long hi;
  int m = next_window<G>(it, key, cap, a, keep, -1, 0, hi);
  int K = stage<G>(it, key, feat, cap, m, a, fr);
  if (hi == NO_ID) {               // every candidate staged at once
    for (int c = wg; c < NC; c += NW) {
      float s[MOMENTS];
      unsigned h;
      resident_corner(feat, cap, K, corner_at(c), s, h);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < MOMENTS; ++j) mom[c][j] = s[j];
        hits[c] = (int)h;
      }
    }
    G::sync();
    return;
  }
  // More windows: count every corner's terms and hits over them (a
  // stream of the first class, its ranks running on over the windows),
  for (int c = G::rank(); c < NC; c += G::SIZE) {
    nterm[c] = 0;
    hits[c] = 0;
  }
  G::sync();
  long long prev = -1;
  for (int w = 0;;) {
    for (int c = wg; c < NC; c += NW) {
      Class cl;
      cl.p = 0;
      cl.G = 1;
      cl.r0 = nterm[c];
      clear(cl.leaf);
      unsigned h = 0;
      class_scan<true>(feat, cap, K, corner_at(c), cl, h);
      __syncwarp();
      if (lane == 0) {
        nterm[c] = cl.r0;
        hits[c] += (int)h;
      }
    }
    if (hi == NO_ID) break;
    prev = hi;
    m = next_window<G>(it, key, cap, a, keep, prev, ++w, hi);
    K = stage<G>(it, key, feat, cap, m, a, fr);
  }
  G::sync();
  // then the corners a warp at a time: one stream over the windows a
  // class.
  for (int g = 0; g < NC / NW; ++g) {
    const int c = g * NW + wg;
    const Corner cn = corner_at(c);
    const unsigned P = pow2(nterm[c]), Gc = classes(P);
    const int lg = log2u(Gc);
    unsigned gmax = 0;
    for (int i = 0; i < NW; ++i) gmax = max(gmax, classes(pow2(nterm[g * NW + i])));
    float part[MOMENTS];
    Class cl;
    clear(cl.leaf);
    for (unsigned s = 0; s < gmax; ++s) {
      const bool mine = s < Gc;
      if (mine) {
        cl.p = reverse(s, lg);
        cl.G = Gc;
        cl.r0 = 0;
        clear(cl.leaf);
      }
      prev = -1;
      for (int w = 0;; ++w) {
        m = next_window<G>(it, key, cap, a, keep, prev, w, hi);
        K = stage<G>(it, key, feat, cap, m, a, fr);
        unsigned unused = 0;
        if (mine) class_scan<false>(feat, cap, K, cn, cl, unused);
        if (hi == NO_ID) break;
        prev = hi;
      }
      if (mine) {
        class_reduce(cl, P);
        if (Gc > 1) push(part, cl.leaf, s);
      }
    }
    float s[MOMENTS];
#pragma unroll
    for (int j = 0; j < MOMENTS; ++j)
      s[j] = __shfl_sync(FULL, Gc > 1 ? part[j] : cl.leaf[j], Gc > 1 ? lg : 0);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < MOMENTS; ++j) mom[c][j] = s[j];
    }
  }
  G::sync();
}

// --- the fit (ops/mls.py::_fit, models/), value for value --------------------

// models/common.py::boundary_accept
__device__ __forceinline__ bool boundary_accept(float q_den, float wpp,
                                                const float (&wp)[3],
                                                float sum_w,
                                                const float (&av)[3],
                                                float bf) {
  const float aa = dot3(av, av);
  const float rhs = add(sub(wpp, mul(2.0f, dot3(wp, av))), mul(sum_w, aa));
  return (aa < 3.0f) & (q_den > mul(bf, rhs));
}

// models/sphere.py::sphere_distance
__device__ float sphere_fit(float sum_w, const float (&wp)[3], float wpp,
                            const float (&sn)[3], float wpn, int hits,
                            float bf) {
  const float inv = quo(1.0f, sum_w);
  const float m[3] = {mul(wp[0], inv), mul(wp[1], inv), mul(wp[2], inv)};
  const float q_num = sub(wpn, dot3(m, sn));
  const float q_den = sub(wpp, dot3(m, wp));
  float q = quo(q_num, q_den);
  const bool unstable =
      fabsf(q_den) < mul(mul(EPS4, (float)hits), fabsf(wpp));
  if (unstable || !isfinite(q)) q = 0.0f;
  const float qa = mul(0.5f, q);
  const float b[3] = {mul(sub(sn[0], mul(q, wp[0])), inv),
                      mul(sub(sn[1], mul(q, wp[1])), inv),
                      mul(sub(sn[2], mul(q, wp[2])), inv)};
  const float c = mul(sub(mul(-qa, wpp), dot3(b, wp)), inv);
  const float b2 = dot3(b, b);
  // models/common.py::solve_quadratic(qa * b2, b2, c)
  const float sa = mul(qa, b2);
  const float bdet = add(b2, __fsqrt_rn(sub(mul(b2, b2), mul(mul(4.0f, sa), c))));
  const float x1 = quo(mul(-2.0f, c), bdet);
  const float x2 = quo(bdet, mul(-2.0f, sa));
  float l = isfinite(x1) ? x1 : x2;
  if (!isfinite(l)) l = nan_f();
  const float av[3] = {mul(l, b[0]), mul(l, b[1]), mul(l, b[2])};
  const bool accept = boundary_accept(q_den, wpp, wp, sum_w, av, bf);
  const float f = quo(-dot3(b, av), __fsqrt_rn(b2));
  return accept && hits >= HITS_CUTOFF ? f : nan_f();
}

// models/plane.py::plane_distance
__device__ float plane_fit(float sum_w, const float (&wp)[3], float wpp,
                           const float (&sn)[3], int hits, float bf) {
  const float mean[3] = {quo(wp[0], sum_w), quo(wp[1], sum_w),
                         quo(wp[2], sum_w)};
  const float norm = __fsqrt_rn(dot3(sn, sn));
  const float nrm[3] = {quo(sn[0], norm), quo(sn[1], norm), quo(sn[2], norm)};
  const float dist = -dot3(nrm, mean);
  const float av[3] = {mul(nrm[0], -dist), mul(nrm[1], -dist),
                       mul(nrm[2], -dist)};
  const float q_den = sub(wpp, dot3(mean, wp));
  const bool accept = boundary_accept(q_den, wpp, wp, sum_w, av, bf);
  return accept && hits >= HITS_CUTOFF ? dist : nan_f();
}

// ops/mls.py::_fit: the moments re-centred on the corner, then the model.
__device__ float fit(const float* m, const Corner& c, int hits,
                     const Args& a) {
  const float sum_w = m[0];
  const float wp[3] = {sub(m[1], mul(c.x, sum_w)), sub(m[2], mul(c.y, sum_w)),
                       sub(m[3], mul(c.z, sum_w))};
  const float wpp = add(sub(m[4], mul(2.0f, dot3(c.x, c.y, c.z, m[1], m[2], m[3]))),
                        mul(c.cc, sum_w));
  const float wpn = sub(m[8], dot3(c.x, c.y, c.z, m[5], m[6], m[7]));
  const float sn[3] = {m[5], m[6], m[7]};
  return a.plane ? plane_fit(sum_w, wp, wpp, sn, hits, a.bf)
                 : sphere_fit(sum_w, wp, wpp, sn, wpn, hits, a.bf);
}

// --- the face pass -------------------------------------------------------------

// A face patch row (ops/mls.py::face_rows): face f (axis a = f / 2, the
// in-plane axes b and c following it cyclically, side f % 2), the plane,
// its multiple-of-8 anchor on a, b and c, and its 4 covering tiles.
struct Row {
  int face, a, b, c, plane, base_a, base_b, base_c;
  int tile0, tile1, tile2, tile3;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ Row face_row(int r, const Args& s) {
  const int np = s.tpa + 1, f2 = np * np;
  Row w;
  w.face = r / f2;
  w.a = w.face >> 1;
  w.b = (w.a + 1) % 3;
  w.c = (w.a + 2) % 3;
  const int side = w.face & 1, q = r - w.face * f2;
  const int oa = pick3(s.ox, s.oy, s.oz, w.a);
  const int ob = pick3(s.ox, s.oy, s.oz, w.b);
  const int oc = pick3(s.ox, s.oy, s.oz, w.c);
  const int ra = pick3(s.rx, s.ry, s.rz, w.a);
  w.plane = oa + (side ? ra : 0);
  w.base_a = (w.plane >> 3) * 8;          // >> 3: floor division by 8
  w.base_b = ((ob >> 3) + q / np) * 8;
  w.base_c = ((oc >> 3) + q % np) * 8;
  const int layer = side ? ra >> 3 : 0;
  const int lob = w.base_b - ob, loc = w.base_c - oc;
  const int tb0 = clampi(lob >> 3, 0, s.tpa - 1);
  const int tb1 = clampi((lob + 7) >> 3, 0, s.tpa - 1);
  const int tc0 = clampi(loc >> 3, 0, s.tpa - 1);
  const int tc1 = clampi((loc + 7) >> 3, 0, s.tpa - 1);
  auto tile = [&](int tb, int tc) {
    const int t0 = w.a == 0 ? layer : (w.b == 0 ? tb : tc);
    const int t1 = w.a == 1 ? layer : (w.b == 1 ? tb : tc);
    const int t2 = w.a == 2 ? layer : (w.b == 2 ? tb : tc);
    return (t2 * s.tpa + t1) * s.tpa + t0;
  };
  w.tile0 = tile(tb0, tc0);
  w.tile1 = tile(tb0, tc1);
  w.tile2 = tile(tb1, tc0);
  w.tile3 = tile(tb1, tc1);
  return w;
}

__device__ __forceinline__ int row_tile(const Row& w, int j) {
  return j == 0 ? w.tile0 : (j == 1 ? w.tile1 : (j == 2 ? w.tile2 : w.tile3));
}

// The segment of row tile j at level l: (start, len), empty for a tile
// repeated among the row's earlier tiles.
__device__ __forceinline__ int2 row_segment(const Args& s, const Row& w,
                                            int j, int l) {
  const int tile = row_tile(w, j);
  bool repeat = false;
  for (int i = 0; i < j; ++i) repeat |= row_tile(w, i) == tile;
  if (repeat) return make_int2(0, 0);
  const size_t at = (size_t)tile * s.levels + l;
  return make_int2(__ldg(s.seg_starts + at), __ldg(s.seg_lens + at));
}

// Where row corner k (b = k / 8, c = k % 8) goes in the field, or -1 when
// it lies outside the block or a later face in write_faces' order
// (x-, x+, y-, y+, z-, z+) covers it.
__device__ long long owned_index(const Row& w, int k, const Args& s) {
  const int bdim = 8 * s.tpa;
  const int la = w.plane - pick3(s.ox, s.oy, s.oz, w.a);
  const int lb = w.base_b + k / 8 - pick3(s.ox, s.oy, s.oz, w.b);
  const int lc = w.base_c + k % 8 - pick3(s.ox, s.oy, s.oz, w.c);
  if (lb < 0 || lb >= bdim || lc < 0 || lc >= bdim) return -1;
  const int x = w.a == 0 ? la : (w.b == 0 ? lb : lc);
  const int y = w.a == 1 ? la : (w.b == 1 ? lb : lc);
  const int z = w.a == 2 ? la : (w.b == 2 ? lb : lc);
  for (int g = w.face + 1; g < 6; ++g) {
    const int ag = g >> 1;
    const int lag = (g & 1) ? pick3(s.rx, s.ry, s.rz, ag) : 0;
    if (pick3(x, y, z, ag) == lag) return -1;
  }
  return ((long long)z * bdim + y) * bdim + x;
}

struct FaceKeep {        // the exact splat-to-patch-rectangle test
  int a;
  float plane, b0, c0;
  __device__ __forceinline__ bool operator()(const float4& p) const {
    const float da = sub(coord(p, a), plane);
    const float pb = coord(p, (a + 1) % 3), pc = coord(p, (a + 2) % 3);
    const float db = nan_max(nan_max(sub(b0, pb), sub(pb, add(b0, 7.0f))), 0.0f);
    const float dc = nan_max(nan_max(sub(c0, pc), sub(pc, add(c0, 7.0f))), 0.0f);
    const float rect2 = add(add(mul(da, da), mul(db, db)), mul(dc, dc));
    return mul(rect2, p.w) < RADIUS_CUTOFF;
  }
};

// Row corner k in the row's frame: (plane - base_a, k / 8, k % 8) on (a,
// b, c) (ops/mls.py::face_frames).
struct FaceCorners {
  int a, b;
  float pa;
  __device__ __forceinline__ Corner operator()(int k) const {
    const float cb = (float)(k / 8), cc = (float)(k % 8);
    const float x = a == 0 ? pa : (b == 0 ? cb : cc);
    const float y = a == 1 ? pa : (b == 1 ? cb : cc);
    const float z = a == 2 ? pa : (b == 2 ? cb : cc);
    return make_corner(x, y, z);
  }
};

struct FaceShared {
  Item<MAX_SEGS> it;
  bool occupied[WARPS];        // the batch's rows that have candidates
  float mom[ROW_CORNERS][MOMENTS];
  int hits[ROW_CORNERS];
  unsigned nterm[ROW_CORNERS];
};

// An empty row, by its warp: NaN on its corners (moments mode: zeros).
__device__ void write_empty_row(const Args& s, const Row& w, int r) {
  for (int k = lane_id(); k < ROW_CORNERS; k += WARP) {
    if (s.field) {
      const long long at = owned_index(w, k, s);
      if (at >= 0) s.field[at] = nan_f();
    } else {
      const size_t at = (size_t)r * ROW_CORNERS + k;
      for (int j = 0; j < MOMENTS; ++j) s.moments[at * MOMENTS + j] = 0.0f;
      s.hits[at] = 0;
    }
  }
}

// One occupied row (its segments, moments, fit and write), by the CTA.
__device__ void face_row_pass(FaceShared& sh, unsigned long long* key,
                              float* feat, const Args& s, int r) {
  const Row w = face_row(r, s);
  const int nsegs = FACE_TILES * s.levels;
  if ((int)threadIdx.x < nsegs) {
    const int2 seg = row_segment(s, w, threadIdx.x / s.levels,
                                 threadIdx.x % s.levels);
    sh.it.start[threadIdx.x] = seg.x;
    sh.it.len[threadIdx.x] = seg.y;
  }
  segment_prefix<Cta>(sh.it, nsegs);
  const float fa = (float)w.base_a, fb = (float)w.base_b, fc = (float)w.base_c;
  const Frame fr{w.a == 0 ? fa : (w.b == 0 ? fb : fc),
                 w.a == 1 ? fa : (w.b == 1 ? fb : fc),
                 w.a == 2 ? fa : (w.b == 2 ? fb : fc)};
  const FaceKeep keep{w.a, (float)w.plane, fb, fc};
  const FaceCorners corners{w.a, w.b, (float)(w.plane - w.base_a)};
  item_moments<Cta, MAX_SEGS, ROW_CORNERS>(sh.it, key, feat, s.cap, s, keep,
                                           fr, corners, sh.mom, sh.hits,
                                           sh.nterm);
  if (threadIdx.x < ROW_CORNERS) {   // the fit and the write
    const int k = threadIdx.x;
    if (s.field) {
      const long long at = owned_index(w, k, s);
      if (at >= 0) s.field[at] = fit(sh.mom[k], corners(k), sh.hits[k], s);
    } else {
      const size_t at = (size_t)r * ROW_CORNERS + k;
#pragma unroll
      for (int m = 0; m < MOMENTS; ++m)
        s.moments[at * MOMENTS + m] = sh.mom[k][m];
      s.hits[at] = sh.hits[k];
    }
  }
}

// A CTA a batch of 8 rows, a batch's rows S apart (row warp * S + batch).
__global__ void __launch_bounds__(THREADS)
seam_face_kernel(const Args s) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ FaceShared sh;
  unsigned long long* key = reinterpret_cast<unsigned long long*>(dyn);
  float* feat = reinterpret_cast<float*>(key + s.cap);
  const int warp = threadIdx.x / WARP, lane = lane_id();
  const int np = s.tpa + 1, rows = 6 * np * np;
  const int stride = (rows + WARPS - 1) / WARPS;
  // Each warp reads its row's segments: an empty row is written at once.
  const int r = warp * stride + blockIdx.x;
  bool occupied = false;
  if (r < rows) {
    const Row w = face_row(r, s);
    int listed = 0;
    for (int t = lane; t < FACE_TILES * s.levels; t += WARP)
      listed += row_segment(s, w, t / s.levels, t % s.levels).y;
    listed = __reduce_add_sync(FULL, listed);
    if (listed == 0) write_empty_row(s, w, r);
    occupied = listed != 0;
  }
  if (lane == 0) sh.occupied[warp] = occupied;
  __syncthreads();
  // Then the CTA runs the batch's occupied rows.
  for (int j = 0; j < WARPS; ++j) {
    if (!sh.occupied[j]) continue;
    face_row_pass(sh, key, feat, s, j * stride + blockIdx.x);
    __syncthreads();
  }
}

// --- the skeleton pass ----------------------------------------------------------

struct PointKeep {       // the point's own positive-weight test
  float px, py, pz;
  __device__ __forceinline__ bool operator()(const float4& p) const {
    const float dx = sub(p.x, px), dy = sub(p.y, py), dz = sub(p.z, pz);
    return mul(dot3(dx, dy, dz, dx, dy, dz), p.w) < RADIUS_CUTOFF;
  }
};

struct PointCorner {
  Corner c;
  __device__ __forceinline__ Corner operator()(int) const { return c; }
};

struct PointShared {
  Item<MAX_LEVELS> it[WARPS];
  float mom[WARPS][1][MOMENTS];
  int hits[WARPS][1];
  unsigned nterm[WARPS][1];
};

// A warp per point (ops/mls.py::skeleton_points, skeleton_moments,
// fit_points).
__global__ void __launch_bounds__(THREADS, 2)
seam_skeleton_kernel(const Args s) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ PointShared sh;
  const int warp = threadIdx.x / WARP, lane = lane_id();
  const int cap = min(s.cap, POINT_BUFFER);
  unsigned long long* key =
      reinterpret_cast<unsigned long long*>(dyn) + (size_t)warp * cap;
  float* feat = reinterpret_cast<float*>(
                    reinterpret_cast<unsigned long long*>(dyn) + WARPS * cap)
                + (size_t)warp * FEAT * cap;
  Item<MAX_LEVELS>& it = sh.it[warp];
  const int bdim = 8 * s.tpa;
  for (int i = blockIdx.x * WARPS + warp; i < s.num_points;
       i += gridDim.x * WARPS) {
    const long long px = s.points[3 * (size_t)i];
    const long long py = s.points[3 * (size_t)i + 1];
    const long long pz = s.points[3 * (size_t)i + 2];
    const long long lx = px - s.ox, ly = py - s.oy, lz = pz - s.oz;
    const bool inside = px >= 0 && py >= 0 && pz >= 0 && lx >= 0 &&
                        ly >= 0 && lz >= 0 && lx < bdim && ly < bdim &&
                        lz < bdim;
    if (!inside) {
      if (!s.field && lane < MOMENTS) s.moments[(size_t)i * MOMENTS + lane] = 0.0f;
      if (!s.field && lane == 0) s.hits[i] = 0;
      continue;
    }
    const int tile = (int)(((lz >> 3) * s.tpa + (ly >> 3)) * s.tpa + (lx >> 3));
    if (lane < s.levels) {
      const size_t at = (size_t)tile * s.levels + lane;
      it.start[lane] = __ldg(s.seg_starts + at);
      it.len[lane] = __ldg(s.seg_lens + at);
    }
    segment_prefix<Warp>(it, s.levels);
    // the frame: the global 8-aligned cube holding the point
    const long long bx = (px >> 3) * 8, by = (py >> 3) * 8, bz = (pz >> 3) * 8;
    const Frame fr{(float)bx, (float)by, (float)bz};
    const PointCorner corner{make_corner((float)(px - bx), (float)(py - by),
                                         (float)(pz - bz))};
    const PointKeep keep{(float)px, (float)py, (float)pz};
    item_moments<Warp, MAX_LEVELS, 1>(it, key, feat, cap, s, keep, fr,
                                      corner, sh.mom[warp], sh.hits[warp],
                                      sh.nterm[warp]);
    if (s.field) {
      if (lane == 0)
        s.field[(lz * bdim + ly) * bdim + lx] =
            fit(sh.mom[warp][0], corner.c, sh.hits[warp][0], s);
    } else {
      if (lane < MOMENTS)
        s.moments[(size_t)i * MOMENTS + lane] = sh.mom[warp][0][lane];
      if (lane == 0) s.hits[i] = sh.hits[warp][0];
    }
    __syncwarp();
  }
}

int check_args(int levels, int tpa, int cap) {
  if (levels < 1 || levels > MAX_LEVELS || tpa < 1)
    return (int)cudaErrorInvalidValue;
  if (cap < FACE_TILES || cap > MAX_BUFFER || (cap & (cap - 1)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Launch `kernel` over `batches` work batches, a CTA a batch, allowing it
// `most` bytes of dynamic shared memory (its largest buffer).
int launch(void (*kernel)(Args), const Args& a, int batches, size_t smem,
           size_t most, void* stream) {
  if (batches == 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batches, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(const float* entry, const long long* vals,
               const int* seg_starts, const int* seg_lens, int levels,
               int tpa, int ox, int oy, int oz, int plane, float bf, int cap,
               float* field, float* moments, int* hits) {
  Args a{};
  a.entry = entry;
  a.vals = vals;
  a.seg_starts = seg_starts;
  a.seg_lens = seg_lens;
  a.levels = levels;
  a.tpa = tpa;
  a.cap = cap;
  a.ox = ox;
  a.oy = oy;
  a.oz = oz;
  a.plane = plane;
  a.bf = bf;
  a.field = field;
  a.moments = moments;
  a.hits = hits;
  return a;
}

}  // namespace

// C entry points. Each launches on `stream` without synchronising and
// returns the launch's cudaError_t (0 = queued). `cap` is the candidate
// buffer of a face row's window: a power of two in [4, seam_max_buffer()]
// (a point's window is min(cap, 128)); a smaller one only runs more
// windows. With `field` given, the pass writes the field in place
// (field mode); with `field` null it writes `moments` and `hits` instead
// (moments mode, for the tests).
extern "C" int seam_max_buffer() { return MAX_BUFFER; }

// seam_face_launch: every face patch row of the block with cell origin
// (ox, oy, oz), region cells (rx, ry, rz) and tpa^3 tiles
// (mls.py::face_rows, R = 6 (tpa + 1)^2 rows); field (8 tpa)^3 f32
// [z, y, x], or moments (R, 64, 9) f32 and hits (R, 64) int32.
extern "C" int seam_face_launch(const float* entry, const long long* vals,
                                const int* seg_starts, const int* seg_lens,
                                int levels, int tpa, int ox, int oy, int oz,
                                int rx, int ry, int rz, int plane, float bf,
                                int cap, float* field, float* moments,
                                int* hits, void* stream) {
  const int bad = check_args(levels, tpa, cap);
  if (bad) return bad;
  Args a = make_args(entry, vals, seg_starts, seg_lens, levels, tpa, ox, oy,
                     oz, plane, bf, cap, field, moments, hits);
  a.rx = rx;
  a.ry = ry;
  a.rz = rz;
  const int rows = 6 * (tpa + 1) * (tpa + 1);
  const size_t per = sizeof(unsigned long long) + FEAT * sizeof(float);
  return launch(seam_face_kernel, a, (rows + WARPS - 1) / WARPS, cap * per,
                MAX_BUFFER * per, stream);
}

// seam_skeleton_launch: every skeleton point, points (P, 3) int64 global
// corners; field as above (written at the points inside the block), or
// moments (P, 1, 9) f32 and hits (P, 1) int32 (zeros outside).
extern "C" int seam_skeleton_launch(const float* entry, const long long* vals,
                                    const int* seg_starts,
                                    const int* seg_lens, int levels, int tpa,
                                    int ox, int oy, int oz,
                                    const long long* points, int num_points,
                                    int plane, float bf, int cap,
                                    float* field, float* moments, int* hits,
                                    void* stream) {
  const int bad = check_args(levels, tpa, cap);
  if (bad) return bad;
  Args a = make_args(entry, vals, seg_starts, seg_lens, levels, tpa, ox, oy,
                     oz, plane, bf, cap, field, moments, hits);
  a.points = points;
  a.num_points = num_points;
  const int pcap = cap < POINT_BUFFER ? cap : POINT_BUFFER;
  const size_t per = WARPS * (sizeof(unsigned long long) + FEAT * sizeof(float));
  return launch(seam_skeleton_kernel, a, (num_points + WARPS - 1) / WARPS,
                pcap * per, POINT_BUFFER * per, stream);
}

// seam_kernel_attributes: what device memory the seam kernels make the
// driver reserve on `device`: out[0] the larger of their local memory
// bytes a thread (cudaFuncGetAttributes), out[1] the multiprocessors,
// out[2] the threads a multiprocessor holds, out[3] and out[4] the face
// and skeleton kernels' registers a thread. Returns the cudaError_t.
extern "C" int seam_kernel_attributes(int device, int* out) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  cudaFuncAttributes fa{}, sa{};
  if ((err = cudaFuncGetAttributes(&fa, seam_face_kernel)) == cudaSuccess &&
      (err = cudaFuncGetAttributes(&sa, seam_skeleton_kernel)) == cudaSuccess &&
      (err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount,
                                    device)) == cudaSuccess &&
      (err = cudaDeviceGetAttribute(
           &out[2], cudaDevAttrMaxThreadsPerMultiProcessor, device)) ==
          cudaSuccess) {
    out[0] = (int)(fa.localSizeBytes > sa.localSizeBytes ? fa.localSizeBytes
                                                         : sa.localSizeBytes);
    out[3] = fa.numRegs;
    out[4] = sa.numRegs;
  }
  cudaSetDevice(prev);
  return (int)err;
}
