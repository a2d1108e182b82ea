// The weld and the pack of the packed and raw readbacks as hand kernels:
// the weld's stable radix sort of the compact vertex keys
// (weld_sort_histogram_kernel, then weld_sort_pass_kernel a digit), its
// compaction (weld_compact_kernel) and the image (pack_readback_kernel).
// The unwelded mesh they take comes from marching.cu's classify, scan and
// march_emit_mesh_kernel.
//
// They stand for programs the JAX package compiles with XLA:
// mlsgpu_tpu/ops/weld.py::weld (:34) and mlsgpu_tpu/ops/block.py::
// _pack_readback (:205), jitted at mlsgpu_tpu/ops/block.py:647-656. Their
// plain PyTorch versions are mlsgpu_tpu_torch/ops/weld.py::weld and
// mlsgpu_tpu_torch/ops/block.py::pack_readback, which the kernels equal
// bit for bit (mesh.cuh holds the arithmetic they share with a host
// build, radix_sort.cuh the sort, scan.cuh the look-back scan).
// ops/mls_cuda.py builds this file with the other kernels into one
// library; ops/mesh_cuda.py calls the C entry points below through ctypes,
// on PyTorch's current stream, without synchronising: the wrapper's one
// sync is the copy of the welded counts, which size the image.
//
// What bounds them on the H100, and what the design does about it: each
// moves a few bytes a vertex or a triangle and does a handful of integer
// and float operations on them, so device memory and, at a block's sizes
// (~10^5-10^6 vertices), the launches bound them; the plain chain is ~100
// elementwise launches, a torch.sort, a nonzero and two host syncs.
//   * the sort: the plain weld sorts the 64-bit (hi, lo) keys; the kernels
//     sort the compact keys (mesh.cuh), 3 axis_bits + 1 bits: 28 at 256^3,
//     31 at 512^3, so 4 passes of 8-bit digits on 32-bit keys between
//     passes, as binning's sort (radix_sort.cuh); above 32 bits (1024^3
//     and up, 34-43 bits) the keys stay 64-bit between passes, 5 or 6
//     passes, a tile of 2,048 keys a CTA. The histogram kernel also clears
//     the passes' and the compaction's scan state.
//   * weld_compact_kernel: a CTA a ticketed tile of 2,048 sorted keys, 8
//     a thread: the first of each run of equal keys is a welded vertex; a
//     CTA scan and a look-back over lower tiles (scan.cuh) of two counts
//     (welded vertices, and those internal: the external flag is the key's
//     top bit, so externals come last) give each its welded index, and the
//     thread writes the welded vertex (the run's first, its lowest
//     emission index: the stable sort's representative), its key halves,
//     and the old -> new remap of every vertex of the run; the last tile
//     writes the totals (welded vertices, first external).
//   * pack_readback_kernel: a thread a welded vertex (its 3 or 4 u16
//     words) and a thread a triangle (its remapped indices, as u16, u21x3
//     or u32 words), one launch over both ranges, written as halfwords
//     and words into the image's final layout (a halfword shared by two
//     threads is never read, modified and written); the pad halfwords
//     zero. Raw readback runs it as the triangles' remap alone, into int32
//     triangles.

#include <cuda_runtime.h>

#include "mesh.cuh"
#include "radix_sort.cuh"
#include "scan.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int HIST_KEYS = SORT_THREADS * SORT_HIST_ITEMS;
constexpr int WELD_ITEMS = MESH_WELD_ITEMS;
constexpr int WELD_TILE = MESH_WELD_TILE;
static_assert(MESH_WELD_THREADS == THREADS, "one CTA size");

// --- the sort ----------------------------------------------------------

template <typename K>
__global__ void __launch_bounds__(SORT_THREADS)
weld_sort_histogram_kernel(const long long* __restrict__ keys, int n,
                           const __grid_constant__ SortPlan plan,
                           unsigned* __restrict__ hist,
                           unsigned long long* __restrict__ state,
                           long long state_words) {
  sort_histogram_body<K, SortIdentity<K>>(keys, n, plan, hist, state,
                                          state_words);
}

template <typename K, bool FIRST, bool LAST>
__global__ void __launch_bounds__(SORT_THREADS)
weld_sort_pass_kernel(const void* __restrict__ keys_in,
                      const int* __restrict__ idx_in, int n,
                      const __grid_constant__ SortPlan plan, int pass,
                      const unsigned* __restrict__ hist,
                      unsigned long long* state, void* __restrict__ keys_out,
                      void* __restrict__ idx_out) {
  sort_pass_body<K, SortIdentity<K>, FIRST, LAST>(
      keys_in, idx_in, n, plan, pass, hist, state, keys_out, idx_out);
}

// The sort's launches on the stream: a memset of the histograms, the
// histogram kernel (which also clears `extra_words` words of state after
// the passes'), then a pass kernel a digit; the pass before the last
// writes into `work` and the one before that into the outputs' memory (as
// K keys and int32 indices), and so on back, so that no pass reads what
// it writes.
template <typename K>
cudaError_t weld_sort(const long long* keys, int n, const SortPlan& plan,
                      long long* sorted, long long* perm, int* work,
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
  K* work_keys = reinterpret_cast<K*>(work);
  int* work_idx = reinterpret_cast<int*>(work_keys + n);
  const void* in_keys = keys;
  const int* in_idx = nullptr;
  for (int p = 0; p < plan.passes; ++p) {
    const bool first = p == 0, last = p == plan.passes - 1;
    const bool to_work = !last && (plan.passes - 2 - p) % 2 == 0;
    void* out_keys = to_work ? static_cast<void*>(work_keys) : sorted;
    void* out_idx = to_work ? static_cast<void*>(work_idx) : perm;
    auto kernel = first ? (last ? weld_sort_pass_kernel<K, true, true>
                                : weld_sort_pass_kernel<K, true, false>)
                        : (last ? weld_sort_pass_kernel<K, false, true>
                                : weld_sort_pass_kernel<K, false, false>);
    kernel<<<tiles, SORT_THREADS, 0, s>>>(in_keys, in_idx, n, plan, p, hist,
                                          state + p * pass_words, out_keys,
                                          out_idx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    in_keys = out_keys;
    in_idx = static_cast<const int*>(out_idx);
  }
  return cudaSuccess;
}

// --- the compaction ----------------------------------------------------

// A ticketed tile of WELD_TILE sorted keys, WELD_ITEMS consecutive ones a
// thread. Position e starts a run when e == 0 or its key differs from the
// one before; the run's welded index is the runs that start at or before
// e, minus one. ext_bit: the external flag's bit in the compact key.
__global__ void __launch_bounds__(THREADS)
weld_compact_kernel(const long long* __restrict__ sorted,
                    const long long* __restrict__ perm, int n, int ext_bit,
                    const float* __restrict__ vertices,
                    const unsigned* __restrict__ key_hi,
                    const unsigned* __restrict__ key_lo,
                    unsigned long long* state, float* __restrict__ out_vertices,
                    unsigned* __restrict__ out_hi,
                    unsigned* __restrict__ out_lo, int* __restrict__ remap,
                    long long* __restrict__ totals) {
  __shared__ unsigned scan_shared[MESH_WELD_COUNTS * 33];
  __shared__ unsigned long long base[MESH_WELD_COUNTS];
  const int tile = scan_ticket(state);
  unsigned long long* const status = state + 1;
  const long long first = (long long)tile * WELD_TILE +
                          (long long)threadIdx.x * WELD_ITEMS;
  // this thread's keys, the one before them, and which start a run (bit
  // i) and of those which are internal
  long long key[WELD_ITEMS];
#pragma unroll
  for (int i = 0; i < WELD_ITEMS; ++i)
    key[i] = first + i < n ? __ldg(&sorted[first + i]) : 0LL;
  long long prev = first > 0 && first <= n ? __ldg(&sorted[first - 1]) : 0LL;
  unsigned starts = 0u, internal = 0u;
#pragma unroll
  for (int i = 0; i < WELD_ITEMS; ++i) {
    const long long e = first + i;
    if (e < n && (e == 0 || key[i] != prev)) {
      starts |= 1u << i;
      if (((key[i] >> ext_bit) & 1LL) == 0) internal |= 1u << i;
    }
    prev = key[i];
  }
  const unsigned v[MESH_WELD_COUNTS] = {(unsigned)__popc(starts),
                                        (unsigned)__popc(internal)};
  unsigned at[MESH_WELD_COUNTS], total[MESH_WELD_COUNTS];
  scan_cta<MESH_WELD_COUNTS>(v, at, total, scan_shared);
  if (threadIdx.x < MESH_WELD_COUNTS) {
    const int k = threadIdx.x;
    unsigned long long* word =
        status + (long long)tile * MESH_WELD_COUNTS + k;
    unsigned long long excl = 0;
    if (tile == 0) {
      scan_publish(word, SCAN_INCLUSIVE, total[k]);
    } else {
      scan_publish(word, SCAN_AGGREGATE, total[k]);
      excl = scan_lookback(status + k, MESH_WELD_COUNTS, tile);
      scan_publish(word, SCAN_INCLUSIVE, excl + total[k]);
    }
    base[k] = excl;
    if (tile == (int)gridDim.x - 1) totals[k] = (long long)(excl + total[k]);
  }
  // the permutation of the thread's keys and the representatives' vertex
  // and key halves, every load in flight before the writes
  long long p[WELD_ITEMS];
  float pos[WELD_ITEMS][3];
  unsigned rep_hi[WELD_ITEMS], rep_lo[WELD_ITEMS];
#pragma unroll
  for (int i = 0; i < WELD_ITEMS; ++i)
    p[i] = first + i < n ? __ldg(&perm[first + i]) : 0LL;
#pragma unroll
  for (int i = 0; i < WELD_ITEMS; ++i) {
    if ((starts >> i) & 1u) {
      pos[i][0] = __ldg(&vertices[3 * p[i]]);
      pos[i][1] = __ldg(&vertices[3 * p[i] + 1]);
      pos[i][2] = __ldg(&vertices[3 * p[i] + 2]);
      rep_hi[i] = __ldg(&key_hi[p[i]]);
      rep_lo[i] = __ldg(&key_lo[p[i]]);
    }
  }
  __syncthreads();
  // the welded index of the run of the thread's first key, less one where
  // that key starts a run
  long long id = (long long)(base[0] + at[0]) - 1;
#pragma unroll
  for (int i = 0; i < WELD_ITEMS; ++i) {
    if (first + i >= n) break;
    if ((starts >> i) & 1u) {
      ++id;
      out_vertices[3 * id] = pos[i][0];
      out_vertices[3 * id + 1] = pos[i][1];
      out_vertices[3 * id + 2] = pos[i][2];
      out_hi[id] = rep_hi[i];
      out_lo[id] = rep_lo[i];
    }
    remap[p[i]] = (int)id;
  }
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

unsigned int blocks_for(long long items) {
  return (unsigned int)((items + THREADS - 1) / THREADS);
}

}  // namespace

// weld_launch: the weld of n unwelded vertices (0 < n < 2^31) by their
// compact sort keys of key_bits bits (the external flag the top one): the
// sort of the keys into `sorted` and `perm` (n int64 each), then the
// compaction: the welded vertices (3 floats each) and key halves in
// out_vertices, out_hi, out_lo (n each, the first `welded` live), the
// remap of every unwelded vertex (n int32), and `totals` (welded
// vertices, first external; int64). `work`: mesh_weld_work_words int32
// words, `scratch`: mesh_weld_scratch_words 64-bit words (mesh.cuh).
extern "C" int weld_launch(const long long* sort_keys, long long n,
                           int key_bits, const float* vertices,
                           const unsigned* key_hi, const unsigned* key_lo,
                           long long* sorted, long long* perm, int* work,
                           unsigned long long* scratch, float* out_vertices,
                           unsigned* out_hi, unsigned* out_lo, int* remap,
                           long long* totals, void* stream) {
  if (n <= 0 || n >= (1LL << 31) || key_bits < 2 || key_bits > 64 ||
      mesh_sort_passes(key_bits) > SORT_MAX_PASSES)
    return (int)cudaErrorInvalidValue;
  const SortPlan plan = sort_plan(key_bits, 0u);
  if (plan.passes > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  const int kb = mesh_sort_key_bytes(key_bits);
  const cudaStream_t s = (cudaStream_t)stream;
  const long long state_words = mesh_weld_state_words(n);
  unsigned long long* weld_state =
      scratch + sort_scratch_words(n, plan.passes, kb);
  cudaError_t err =
      kb == 4 ? weld_sort<unsigned>(sort_keys, (int)n, plan, sorted, perm,
                                    work, scratch, state_words, s)
              : weld_sort<unsigned long long>(sort_keys, (int)n, plan, sorted,
                                              perm, work, scratch, state_words,
                                              s);
  if (err != cudaSuccess) return (int)err;
  weld_compact_kernel<<<(unsigned)((n + WELD_TILE - 1) / WELD_TILE), THREADS,
                        0, s>>>(sorted, perm, (int)n, key_bits - 1, vertices,
                                key_hi, key_lo, weld_state, out_vertices,
                                out_hi, out_lo, remap, totals);
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
