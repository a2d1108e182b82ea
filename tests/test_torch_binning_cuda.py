"""The binning stage's kernel path (ops/binning_cuda.py, csrc/binning.cu).

On the CPU: the wrappers take the plain versions and launch nothing; the
kernels' arithmetic (csrc/binning.cuh) built for the host with g++
-ffp-contract=off and held to the plain versions bit for bit on clouds
with splats on slab boundaries, at the conservative test's margin and with
giant radii (`edge_cloud`; tests/test_torch_binning.py holds the plain
versions to the JAX package on the same clouds); the 32-bit Morton spread
and the level table against ops/morton.py and binning.level_offsets; the
segments' two passes (the bounds pass CTA by CTA, its warp searches lane
by lane, then the gather) against
binning.node_bounds and binning.tile_segments on edge cases
(`segment_case`); the build, the launch counters (also carried back from
worker processes), no splats, and a device the wrappers cannot take. On
the card (marker `cuda`): keys, entries, bounds and segments bit for bit
against the plain versions (the segments on the edge cases too), and one
launch of each kernel a block.

This module imports no jax: a worker process imports it for its block
step (CountingStep) and must not pay for jax, and the card's machine has
none; there an installed package named `tests` also shadows
`tests.oracle`.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mlsgpu_tpu_torch.ops import binning, binning_cuda, block, launches, mls_cuda
from mlsgpu_tpu_torch.ops.block import block_step_staged

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mlsgpu_tpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normals(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _sphere(center, radius, n, splat_radius, rng):
    """Splats on an analytic sphere with outward normals (tests/oracle.py's
    fixture, which the card's machine cannot import as `tests`)."""
    v = _normals(rng, n)
    out = np.empty((n, 8), np.float32)
    out[:, 0:3] = np.asarray(center, np.float64) + radius * v
    out[:, 3] = splat_radius
    out[:, 4:7] = v
    out[:, 7] = 1.0 / splat_radius ** 2
    return out


def edge_cloud(kind):
    """(splats (N, 8) f32, valid (N,) bool, cell origin) of a test cloud:
    "sphere" (some rows NaN and invalid), "boundaries" (splats on the
    lattice, px +- r and slab faces coinciding exactly, and splats at the
    conservative test's margin: a slab distance of r times 1 - 2^-23 to
    1.00001), "corners" (splats off a node corner in every axis, at a
    distance within the margin: the sum of three axis terms decides) or
    "giant" (radii up to 1e6 beside small ones, centres outside the block,
    an origin away from 0)."""
    rng = np.random.default_rng(21)
    if kind == "sphere":
        s = _sphere([16.0, 15.0, 17.0], 9.0, 1500, 2.0, rng)
        s[::97, 0] = np.nan
        return s, np.isfinite(s).all(axis=1), (0, 0, 0)
    if kind == "boundaries":
        n = 1600
        s = np.empty((n, 8), np.float32)
        s[:, 0:3] = rng.integers(-4, 36, size=(n, 3))
        s[1::3, 0:3] += 0.5
        s[:, 3] = rng.choice([0.5, 1.0, 2.0, 4.0, 8.0], size=n)
        # a slab face at a multiple of 8, the splat a factor f of r from it
        f = np.float32([1.0, 1.0 - 2.0 ** -23, 1.0 + 2.0 ** -23,
                        1.0 + 2.0 ** -22, 1.000005, 1.00001, 1.0000105])
        m = n // 2
        face = 8.0 * rng.integers(0, 4, size=m)
        side = rng.choice([-1.0, 1.0], size=m)
        s[:m, 0] = (face + side * s[:m, 3] * f[np.arange(m) % len(f)]
                    ).astype(np.float32)
        s[:, 4:7] = _normals(rng, n)
        s[:, 7] = 1.0
        valid = rng.random(n) < 0.95
        return s, valid, (0, 0, 0)
    if kind == "corners":
        n = 4000
        s = np.zeros((n, 8), np.float32)
        s[:, 3] = rng.choice([0.75, 1.5, 3.0], size=n)
        u = np.abs(_normals(rng, n)) + 0.3
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        f = rng.uniform(0.99999, 1.00002, size=(n, 1))
        corner = 8.0 * rng.integers(1, 4, size=(n, 3))
        s[:, 0:3] = corner - s[:, 3:4] * f * u
        s[:, 4:7] = u
        s[:, 7] = 1.0
        return s, np.ones(n, bool), (0, 0, 0)
    s = _sphere([20.0, 12.0, 30.0], 10.0, 900, 1.0, rng)
    s[::7, 3] = rng.choice([40.0, 300.0, 5e4, 1e6], size=len(s[::7]))
    s[::11, 0:3] -= 24.0
    return s, np.ones(len(s), bool), (8, 0, 16)


KINDS = ("sphere", "boundaries", "corners", "giant")


#: The binning kernels' names in ops/launches.py.
BINNING = ("bin_keys", "bin_entries", "tile_bounds", "tile_segments",
           "bin_sort_histogram", "bin_sort_pass")


def _since(before):
    """The binning kernels' launches since `before` (launches.counts())."""
    now = launches.since(before)
    return [now[k] for k in BINNING]


@pytest.mark.parametrize("kind", KINDS)
def test_wrappers_on_cpu_take_the_plain_path(kind):
    splats, valid, origin = edge_cloud(kind)
    sp, va = torch.as_tensor(splats), torch.as_tensor(valid)
    before = launches.counts()
    b = binning_cuda.bin_splats(sp, va, origin, 3, 5)
    s, ln = binning_cuda.tile_segments(b.entry_keys, 3, 5, 4)
    assert launches.counts() == before
    ref = binning.bin_splats(sp, va, origin, 3, 5)
    for name in ("entry_keys", "entry_vals", "entry_data"):
        _same(getattr(b, name), getattr(ref, name), name)
    ref_s, ref_l = binning.tile_segments(ref.entry_keys, 3, 5, 4)
    _same(s, ref_s, "starts")
    _same(ln, ref_l, "lens")
    assert int(ln.sum()) > 0


# --- the kernels' arithmetic, built for the host ----------------------------

# The kernels' bodies (csrc/binning.cu) as host loops over binning.cuh:
# the bounds pass CTA by CTA (BIN_BOUND_THREADS node keys each), its warp
# searches lane by lane.
_HARNESS = """
#include <algorithm>
#include <vector>

#include "binning.cuh"
#include "scan.cuh"

extern "C" float host_r2_factor() { return BIN_R2_FACTOR; }

extern "C" unsigned host_spread(unsigned x) { return bin_spread(x); }

extern "C" unsigned host_morton(unsigned x, unsigned y, unsigned z) {
  return bin_morton(x, y, z);
}

extern "C" int host_level_offsets(int min_shift, int max_shift, int* out) {
  const BinShape shape = bin_shape(min_shift, max_shift, 0, 0, 0);
  for (int li = 0; li <= max_shift - min_shift; ++li)
    out[li] = shape.level_offset[li];
  return bin_nodes(shape);
}

extern "C" void host_keys(const float* s, const unsigned char* valid,
                          long long n, int min_shift, int max_shift,
                          long long ox, long long oy, long long oz,
                          long long* keys) {
  const BinShape shape = bin_shape(min_shift, max_shift, ox, oy, oz);
  for (long long i = 0; i < n; ++i) {
    long long k[8];
    bin_splat_keys(s[8 * i], s[8 * i + 1], s[8 * i + 2], s[8 * i + 3],
                   valid[i] != 0, shape, k);
    for (int c = 0; c < 8; ++c) keys[c * n + i] = k[c];
  }
}

extern "C" void host_entries(const float* s, const long long* perm,
                             long long n, float* data, long long* vals) {
  for (long long e = 0; e < 8 * n; ++e) {
    const long long v = perm[e] % n;
    vals[e] = v;
    for (int a = 0; a < 8; ++a) data[8 * e + a] = s[8 * v + a];
    data[8 * e + 3] = bin_inv_r2(s[8 * v + 3]);
  }
}

// warp_lower_bound: the 32 lanes' probes of a round counted one by one.
static int warp_lower_bound(const long long* keys, int m, long long q) {
  int lo = 0, hi = m;
  while (lo < hi) {
    int below = 0;
    for (int lane = 0; lane < 32; ++lane) {
      const int idx = bin_probe(lo, hi, lane);
      below += idx >= 0 && keys[idx] < q;
    }
    bin_narrow(lo, hi, below);
  }
  return lo;
}

// tile_bounds_kernel: each CTA's key range, then a search in it.
extern "C" int host_bounds(const long long* keys, int m, int min_shift,
                           int max_shift, int* bounds) {
  const int nodes = bin_nodes(bin_shape(min_shift, max_shift, 0, 0, 0));
  for (int q0 = 0; q0 <= nodes; q0 += BIN_BOUND_THREADS) {
    const int last = std::min(q0 + BIN_BOUND_THREADS - 1, nodes);
    const int lo = warp_lower_bound(keys, m, q0);
    const int hi = warp_lower_bound(keys, m, last);
    for (int q = q0; q <= last; ++q) bounds[q] = bin_lower_bound(keys, lo, hi, q);
  }
  return nodes;
}

extern "C" int host_sort_plan(int min_shift, int max_shift, int* shift,
                              int* bits, unsigned* top) {
  const BinSortPlan plan = bin_sort_plan(min_shift, max_shift);
  for (int p = 0; p < plan.passes; ++p) {
    shift[p] = plan.shift[p];
    bits[p] = plan.bits[p];
  }
  *top = plan.top;
  return plan.passes;
}

extern "C" void host_sort_map(const long long* keys, long long n,
                              unsigned top, unsigned* mapped,
                              long long* back) {
  for (long long i = 0; i < n; ++i) {
    mapped[i] = bin_sort_map(keys[i], top);
    back[i] = bin_sort_unmap(mapped[i], top);
  }
}

extern "C" long long host_sort_scratch_words(long long n, int min_shift,
                                             int max_shift) {
  return bin_sort_scratch_words(n, bin_sort_plan(min_shift, max_shift).passes);
}

extern "C" unsigned long long host_scan_word(unsigned flag,
                                             unsigned long long value) {
  return scan_word(flag, value);
}

extern "C" unsigned host_scan_flag(unsigned long long w) { return scan_flag(w); }

extern "C" unsigned long long host_scan_value(unsigned long long w) {
  return scan_value(w);
}

extern "C" int host_window_step(const unsigned long long* words, int n,
                                unsigned long long* sum, int* done) {
  bool d;
  const int taken = scan_window_step(words, n, *sum, &d);
  *done = d;
  return taken;
}

// scan_lookback_group on the host, every group sum complete: the groups
// below g nearest first, SCAN_GROUP_WINDOW a round, each its exclusive
// prefix plus its sum where its first tile has published the former, else
// its sum. Counts the rounds in *rounds.
static unsigned long long group_lookback(const unsigned* excl,
                                         const unsigned* sums, int stride,
                                         long long g, int* rounds) {
  unsigned long long sum = 0, w[SCAN_GROUP_WINDOW];
  long long next = g - 1;
  bool done = false;
  *rounds = 0;
  while (!done) {
    for (int i = 0; i < SCAN_GROUP_WINDOW; ++i) {
      const long long q = next - i;
      w[i] = q >= 0 ? scan_group_status(q > 0 ? excl[q * stride] : 0u,
                                        sums[q * stride], q == 0)
                    : scan_word(SCAN_INCLUSIVE, 0ULL);
    }
    next -= scan_window_step(w, SCAN_GROUP_WINDOW, sum, &done);
    ++*rounds;
  }
  return sum;
}

// scan_lookback_in_group on the host: the group's exclusive prefix (0 for
// group 0) plus its lower tiles' counts; -1 where a word it needs is not
// yet published (the card would wait on it).
static long long in_group_lookback(const unsigned* counts,
                                   const unsigned* excl, int stride,
                                   long long tile) {
  const long long g = tile / SCAN_GROUP;
  const int r = (int)(tile - g * SCAN_GROUP);
  const unsigned x = g > 0 ? excl[g * stride] : 1u;
  if (x == 0u) return -1;
  long long sum = x - 1u;
  for (int i = 0; i < r; ++i) {
    const unsigned w = counts[(tile - 1 - i) * stride];
    if (w == 0u) return -1;
    sum += w - 1u;
  }
  return sum;
}

// A tile's exclusive prefix for one count by the two-level look-back
// (sort_pass_body): a group's first tile looks back over the groups below
// and publishes the group's prefix, any other tile adds its group's lower
// tiles' counts to that prefix. -1 as in_group_lookback.
static long long two_level(const unsigned* counts, const unsigned* sums,
                           unsigned* excl, int stride, long long tile,
                           int* rounds) {
  const long long g = tile / SCAN_GROUP;
  *rounds = 0;
  if (tile % SCAN_GROUP != 0) return in_group_lookback(counts, excl, stride,
                                                       tile);
  if (g == 0) return 0;
  const unsigned long long b = group_lookback(excl, sums, stride, g, rounds);
  excl[g * stride] = scan_excl_word((unsigned)b);
  return (long long)b;
}

// The order in which a pass's tiles look back on the host: in ticket order,
// or, `descending`, from the last; for the two-level look-back (`grouped`)
// the groups' first tiles from the last first (each walking every group
// sum below it), then the others.
static std::vector<long long> lookback_order(long long tiles, int descending,
                                             bool grouped) {
  std::vector<long long> order;
  for (int first = 1; first >= 0; --first)
    for (long long k = 0; k < tiles; ++k) {
      const long long t = descending ? tiles - 1 - k : k;
      if (!descending || !grouped ||
          (t % SCAN_GROUP == 0) == (first == 1))
        order.push_back(t);
    }
  order.resize(tiles);
  return order;
}

// scan_lookback on the host: SCAN_WINDOW words a round, below tile 0 an
// inclusive 0.
static unsigned long long lookback(const unsigned long long* words,
                                   int stride, long long tile) {
  unsigned long long sum = 0, w[SCAN_WINDOW];
  long long next = tile - 1;
  while (next >= 0) {
    for (int i = 0; i < SCAN_WINDOW; ++i)
      w[i] = next - i >= 0 ? words[(next - i) * stride]
                           : scan_word(SCAN_INCLUSIVE, 0ULL);
    bool done;
    next -= scan_window_step(w, SCAN_WINDOW, sum, &done);
    if (done) break;
  }
  return sum;
}

// The two-level scan of `tiles` tiles' counts as a pass runs it: every
// tile publishes (its count word, its group's sum), then the tiles look
// back in lookback_order, in ticket order or from the last. excl: each
// tile's exclusive prefix; rounds: a first tile's look-back's rounds (0
// for the others). Returns -1 where a tile read an unpublished word.
extern "C" int host_grouped_scan(const unsigned* counts, int tiles,
                                 int descending, unsigned long long* excl,
                                 int* rounds) {
  const int groups = (tiles + SCAN_GROUP - 1) / SCAN_GROUP;
  std::vector<unsigned> words(tiles), sums(groups, 0u), gx(groups, 0u);
  for (int t = 0; t < tiles; ++t) {
    words[t] = scan_count_word(counts[t]);
    sums[t / SCAN_GROUP] += scan_group_add(counts[t]);
  }
  for (long long t : lookback_order(tiles, descending, true)) {
    const long long b = two_level(words.data(), sums.data(), gx.data(), 1, t,
                                  &rounds[t]);
    if (b < 0) return -1;
    excl[t] = (unsigned long long)b;
  }
  return 0;
}

extern "C" int host_sort_grouped(long long tiles) { return sort_grouped(tiles); }

extern "C" unsigned long long host_group_status(unsigned excl, unsigned sum,
                                                int first) {
  return scan_group_status(excl, sum, first != 0);
}

// match_digit (a match.any on the card): the lanes whose digit and
// validity equal lane l's, here a ballot a bit.
static unsigned match_digit(const unsigned* d, const bool* valid, int lane,
                            int bits) {
  unsigned v = 0;
  for (int l = 0; l < 32; ++l) v |= (unsigned)valid[l] << l;
  unsigned peers = valid[lane] ? v : ~v;
  for (int b = 0; b < bits; ++b) {
    unsigned m = 0;
    for (int l = 0; l < 32; ++l) m |= ((d[l] >> b) & 1u) << l;
    peers &= (d[lane] >> b) & 1u ? m : ~m;
  }
  return peers;
}

// bin_sort_launch: the histogram kernel's counts, then each pass's tiles
// as its kernel runs them, warps and lanes written out. Every tile first
// publishes its counts (as if all ran at once), then the tiles look back
// in lookback_order, in ticket order or from the last: on two levels
// where `grouped` (-1: as the launcher picks, sort_grouped), else
// decoupled (each walking every aggregate below it from the last).
// Returns -1 where a tile read an unpublished word.
extern "C" int host_sort(const long long* keys, long long n, int min_shift,
                         int max_shift, int descending, int grouped_mode,
                         long long* sorted, long long* perm) {
  const BinSortPlan plan = bin_sort_plan(min_shift, max_shift);
  const int R = BIN_SORT_RADIX, W = BIN_SORT_THREADS / 32;
  const int I = BIN_SORT_ITEMS, T = BIN_SORT_TILE;
  std::vector<unsigned> hist(plan.passes * R, 0u);
  std::vector<unsigned> kin(n), kout(n);
  std::vector<int> iin(n), iout(n);
  for (long long e = 0; e < n; ++e) {
    kin[e] = bin_sort_map(keys[e], plan.top);
    iin[e] = (int)e;
    for (int p = 0; p < plan.passes; ++p)
      ++hist[p * R + bin_sort_digit(kin[e], plan.shift[p], plan.bits[p])];
  }
  const long long tiles = bin_sort_tiles(n);
  const long long groups = (tiles + SCAN_GROUP - 1) / SCAN_GROUP;
  const bool grouped =
      grouped_mode < 0 ? sort_grouped(tiles) : grouped_mode == 1;
  std::vector<unsigned> words(tiles * R), sums(groups * R), gx(groups * R);
  std::vector<unsigned long long> status(tiles * R);
  std::vector<std::vector<unsigned short>> rank(tiles), warp_count(tiles);
  std::vector<std::vector<unsigned>> count(tiles);
  for (int p = 0; p < plan.passes; ++p) {
    const int shift = plan.shift[p], bits = plan.bits[p];
    std::fill(words.begin(), words.end(), 0u);
    std::fill(sums.begin(), sums.end(), 0u);
    std::fill(gx.begin(), gx.end(), 0u);
    std::fill(status.begin(), status.end(), 0ULL);
    // ranking and aggregates, every tile
    for (long long tile = 0; tile < tiles; ++tile) {
      const long long first = tile * T;
      const int tile_n = (int)std::min((long long)T, n - first);
      rank[tile].assign(T, 0);
      warp_count[tile].assign(W * R, 0);
      unsigned short* wc = warp_count[tile].data();
      for (int w = 0; w < W; ++w)
        for (int i = 0; i < I; ++i) {
          unsigned d[32], c[32], peers[32];
          bool valid[32];
          for (int l = 0; l < 32; ++l) {
            const int t = w * 32 * I + 32 * i + l;
            valid[l] = t < tile_n;
            d[l] = bin_sort_digit(valid[l] ? kin[first + t] : 0u, shift, bits);
          }
          for (int l = 0; l < 32; ++l) {
            peers[l] = match_digit(d, valid, l, bits);
            c[l] = valid[l] ? wc[w * R + d[l]] : 0u;
            const unsigned before = __builtin_popcount(peers[l] & ((1u << l) - 1u));
            rank[tile][w * 32 * I + 32 * i + l] = (unsigned short)(c[l] + before);
          }
          for (int l = 0; l < 32; ++l)
            if (valid[l] && __builtin_popcount(peers[l] & ((1u << l) - 1u)) == 0)
              wc[w * R + d[l]] = (unsigned short)(c[l] + __builtin_popcount(peers[l]));
        }
      count[tile].assign(R, 0u);
      for (int d = 0; d < R; ++d) {
        unsigned run = 0;
        for (int w = 0; w < W; ++w) {
          const unsigned c = wc[w * R + d];
          wc[w * R + d] = (unsigned short)run;
          run += c;
        }
        count[tile][d] = run;
        words[tile * R + d] = scan_count_word(run);
        sums[tile / SCAN_GROUP * R + d] += scan_group_add(run);
        status[tile * R + d] =
            scan_word(tile == 0 ? SCAN_INCLUSIVE : SCAN_AGGREGATE, run);
      }
    }
    // look-back, staging and the write-out, tile by tile
    for (long long tile : lookback_order(tiles, descending, grouped)) {
      const long long first = tile * T;
      const int tile_n = (int)std::min((long long)T, n - first);
      std::vector<int> shift_out(R), digit_start(R);
      unsigned excl0 = 0, excl1 = 0;
      for (int d = 0; d < R; ++d) {
        int rounds;
        long long below = 0;
        if (grouped) {
          below = two_level(words.data() + d, sums.data() + d, gx.data() + d,
                            R, tile, &rounds);
          if (below < 0) return -1;
        } else if (tile > 0) {
          below = (long long)lookback(status.data() + d, R, tile);
          status[tile * R + d] =
              scan_word(SCAN_INCLUSIVE, below + count[tile][d]);
        }
        shift_out[d] = (int)(excl1 + below) - (int)excl0;
        digit_start[d] = (int)excl0;
        excl0 += count[tile][d];
        excl1 += hist[p * R + d];
      }
      std::vector<unsigned> staged_keys(T);
      std::vector<int> staged_idx(T);
      for (int t = 0; t < tile_n; ++t) {
        const int w = t / (32 * I);
        const unsigned d = bin_sort_digit(kin[first + t], shift, bits);
        const int at = digit_start[d] + warp_count[tile][w * R + d] + rank[tile][t];
        staged_keys[at] = kin[first + t];
        staged_idx[at] = iin[first + t];
      }
      for (int t = 0; t < tile_n; ++t) {
        const unsigned k2 = staged_keys[t];
        const int at = shift_out[bin_sort_digit(k2, shift, bits)] + t;
        kout[at] = k2;
        iout[at] = staged_idx[t];
      }
    }
    std::swap(kin, kout);
    std::swap(iin, iout);
  }
  for (long long e = 0; e < n; ++e) {
    sorted[e] = bin_sort_unmap(kin[e], plan.top);
    perm[e] = iin[e];
  }
  return plan.passes;
}

// tile_segments_kernel.
extern "C" void host_gather(const int* bounds, int min_shift, int max_shift,
                            int tpa, int* starts, int* lens) {
  const BinShape shape = bin_shape(min_shift, max_shift, 0, 0, 0);
  const int levels = max_shift - min_shift + 1;
  const unsigned tiles = (unsigned)tpa * tpa * tpa;
  for (unsigned t = 0; t < tiles; ++t) {
    const unsigned code = bin_tile_code(t, tpa);
    for (int li = 0; li < levels; ++li) {
      const int node = bin_level_node(code, li, shape);
      starts[t * levels + li] = bounds[node];
      lens[t * levels + li] = bounds[node + 1] - bounds[node];
    }
  }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """binning.cuh built for the host (g++ -ffp-contract=off: no FMA, as
    the kernels' _rn intrinsics), loaded with ctypes."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no C++ compiler to build binning.cuh for the host")
    d = tmp_path_factory.mktemp("binning_host")
    (d / "harness.cpp").write_text(_HARNESS)
    so = str(d / "libharness.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fwrapv", "-shared", "-fPIC", "-I", CSRC, "-o", so,
                    str(d / "harness.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.host_r2_factor.restype = ctypes.c_float
    lib.host_keys.argtypes = [p, p, i64, i32, i32, i64, i64, i64, p]
    lib.host_entries.argtypes = [p, p, i64, p, p]
    u32 = ctypes.c_uint
    lib.host_spread.restype = lib.host_morton.restype = u32
    lib.host_spread.argtypes = [u32]
    lib.host_morton.argtypes = [u32] * 3
    lib.host_level_offsets.restype = i32
    lib.host_level_offsets.argtypes = [i32, i32, p]
    lib.host_bounds.restype = i32
    lib.host_bounds.argtypes = [p, i32, i32, i32, p]
    lib.host_gather.argtypes = [p, i32, i32, i32, p, p]
    lib.host_sort_plan.restype = i32
    lib.host_sort_plan.argtypes = [i32, i32, p, p, p]
    lib.host_sort_map.argtypes = [p, i64, u32, p, p]
    lib.host_sort_scratch_words.restype = i64
    lib.host_sort_scratch_words.argtypes = [i64, i32, i32]
    u64 = ctypes.c_ulonglong
    lib.host_scan_word.restype = u64
    lib.host_scan_word.argtypes = [u32, u64]
    lib.host_scan_flag.restype = u32
    lib.host_scan_flag.argtypes = [u64]
    lib.host_scan_value.restype = u64
    lib.host_scan_value.argtypes = [u64]
    lib.host_window_step.restype = i32
    lib.host_window_step.argtypes = [p, i32, p, p]
    lib.host_sort.restype = i32
    lib.host_sort.argtypes = [p, i64, i32, i32, i32, i32, p, p]
    lib.host_sort_grouped.restype = i32
    lib.host_sort_grouped.argtypes = [i64]
    lib.host_grouped_scan.restype = i32
    lib.host_grouped_scan.argtypes = [p, i32, i32, p, p]
    lib.host_group_status.restype = u64
    lib.host_group_status.argtypes = [u32, u32, i32]
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _host_keys(lib, splats, valid, origin, min_s, max_s):
    splats = np.ascontiguousarray(splats, np.float32)
    valid = np.ascontiguousarray(valid, np.uint8)
    keys = np.empty(8 * len(splats), np.int64)
    lib.host_keys(_ptr(splats), _ptr(valid), len(splats), min_s, max_s,
                  *(int(v) for v in origin), _ptr(keys))
    return keys


def test_host_constant_is_the_plain_factor(host):
    assert np.float32(host.host_r2_factor()) == np.float32(1.00001)


def _fuzz():
    """Random splats around the lattice: positions on integer and
    half-integer cells or an ulp off them, radii from 2^-4 to 2^12 cells."""
    rng = np.random.default_rng(5)
    n = 20000
    s = np.zeros((n, 8), np.float32)
    base = rng.integers(-40, 80, size=(n, 3)) + rng.choice([0.0, 0.5],
                                                           size=(n, 3))
    on = base.astype(np.float32)
    step = rng.integers(-1, 2, size=(n, 3))          # one ulp down, none, up
    s[:, 0:3] = np.where(step == 0, on, np.nextafter(
        on, np.where(step > 0, np.inf, -np.inf).astype(np.float32)))
    s[:, 3] = np.exp2(rng.uniform(-4, 12, n)).astype(np.float32)
    s[:, 4:7] = _normals(rng, n)
    return s, rng.random(n) < 0.9, (-8, 16, 0)


@pytest.mark.parametrize("kind", KINDS + ("fuzz",))
def test_host_build_keys_equal_the_plain_pass(host, kind):
    splats, valid, origin = _fuzz() if kind == "fuzz" else edge_cloud(kind)
    for min_s, max_s in ((3, 5), (3, 8), (5, 6)):
        want = binning.splat_keys(torch.as_tensor(splats),
                                  torch.as_tensor(valid), origin, min_s,
                                  max_s).numpy()
        got = _host_keys(host, splats, valid, origin, min_s, max_s)
        np.testing.assert_array_equal(got, want)
        assert (want != binning.INVALID_KEY).sum() > 100


def test_host_build_entries_equal_the_plain_gather(host):
    splats, valid, origin = _fuzz()
    splats = splats[:3000].copy()
    splats[0:6, 3] = [0.0, 1e-30, 1e30, np.inf, 3e-20, -2.5]  # edge radii
    keys = binning.splat_keys(torch.as_tensor(splats),
                              torch.as_tensor(valid[:3000]), origin, 3, 6)
    _, perm = torch.sort(keys, stable=True)
    want_data, want_vals = binning.entry_rows(torch.as_tensor(splats), perm)
    n = len(splats)
    perm = np.ascontiguousarray(perm.numpy())
    data = np.empty((8 * n, 8), np.float32)
    vals = np.empty(8 * n, np.int64)
    host.host_entries(_ptr(splats), _ptr(perm), n, _ptr(data), _ptr(vals))
    np.testing.assert_array_equal(vals, want_vals.numpy())
    np.testing.assert_array_equal(data.view(np.uint32),
                                  want_data.numpy().view(np.uint32))


def _host_segments(lib, keys, min_s, max_s, tpa):
    """The two passes built for the host: (starts, lens, bounds)."""
    keys = np.ascontiguousarray(keys, np.int64)
    bounds = np.empty(binning.node_count(min_s, max_s) + 1, np.int32)
    assert lib.host_bounds(_ptr(keys), len(keys), min_s, max_s,
                           _ptr(bounds)) == len(bounds) - 1
    shape = (tpa ** 3, max_s - min_s + 1)
    starts = np.empty(shape, np.int32)
    lens = np.empty(shape, np.int32)
    lib.host_gather(_ptr(bounds), min_s, max_s, tpa, _ptr(starts),
                    _ptr(lens))
    return starts, lens, bounds


@pytest.mark.parametrize("levels,sub", [(3, 3), (6, 3), (2, 5)])
def test_host_build_segments_equal_the_plain_search(host, levels, sub):
    splats, valid, origin = edge_cloud("sphere")
    min_s, max_s = sub, levels + sub - 1
    tpa = 1 << (max_s - 3)
    keys, _ = torch.sort(binning.splat_keys(
        torch.as_tensor(splats), torch.as_tensor(valid), origin, min_s,
        max_s), stable=True)
    want_s, want_l = binning.tile_segments(keys, min_s, max_s, tpa)
    starts, lens, _ = _host_segments(host, keys.numpy(), min_s, max_s, tpa)
    np.testing.assert_array_equal(starts, want_s.numpy())
    np.testing.assert_array_equal(lens, want_l.numpy())
    assert int(lens.sum()) > 0


def segment_case(case):
    """(sorted keys (m,) int64, min_shift, max_shift) of an edge case for
    the segments: "empty" (m = 0), "invalid" (every key INVALID_KEY),
    "root" (only the root node), "leaves" (every leaf node, 1-40 entries
    each), "last_leaf"
    (only the last leaf node K0 - 1), "runs" (a few nodes with runs of
    3,000-40,000 entries, among single ones) or "sparse" (a fuzzed sparse
    block at (levels, sub) = (7, 3): 2% of each level's nodes, up to 60
    entries each)."""
    rng = np.random.default_rng(17)
    min_s, max_s = (3, 9) if case == "sparse" else (3, 6)
    offs = binning.level_offsets(min_s, max_s)
    nodes = binning.node_count(min_s, max_s)
    leaves = int(offs[1])
    inv = binning.INVALID_KEY
    if case == "empty":
        keys = np.zeros(0, np.int64)
    elif case == "invalid":
        keys = np.full(5000, inv, np.int64)
    elif case == "root":
        keys = np.concatenate([np.full(700, nodes - 1), np.full(30, inv)])
    elif case == "leaves":
        keys = np.repeat(np.arange(leaves), rng.integers(1, 41, leaves))
    elif case == "last_leaf":
        keys = np.concatenate([np.full(9, leaves - 1), np.full(4, inv)])
    elif case == "runs":
        some = rng.choice(nodes, 60, replace=False)
        reps = np.where(np.arange(60) % 6 == 0,
                        rng.integers(3000, 40000, 60), 1)
        keys = np.concatenate([np.repeat(some, reps), np.full(2000, inv)])
    else:
        parts = []
        for li in range(len(offs)):
            count = (nodes if li == len(offs) - 1 else int(offs[li + 1])
                     ) - int(offs[li])
            occ = rng.random(count) < 0.02
            parts.append(np.repeat(int(offs[li]) + np.flatnonzero(occ),
                                   rng.integers(1, 61, int(occ.sum()))))
        parts.append(np.full(rng.integers(1, 5000), inv))
        keys = np.concatenate(parts)
    return np.sort(keys.astype(np.int64), kind="stable"), min_s, max_s


SEGMENT_CASES = ("empty", "invalid", "root", "leaves", "last_leaf", "runs",
                 "sparse")
_plain_cache = {}


def _plain_segments(case):
    """segment_case(case) and the plain versions' starts, lens and bounds
    (computed once a case)."""
    if case not in _plain_cache:
        keys, min_s, max_s = segment_case(case)
        tpa = 1 << (max_s - 3)
        k = torch.as_tensor(keys)
        s, ln = binning.tile_segments(k, min_s, max_s, tpa)
        b = binning.node_bounds(k, min_s, max_s)
        _plain_cache[case] = (keys, min_s, max_s, tpa, s.numpy(), ln.numpy(),
                              b.numpy())
    return _plain_cache[case]


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_host_build_two_passes_equal_the_plain_segments(host, case):
    """The bounds pass and the gather, built for the host, against
    binning.node_bounds and binning.tile_segments, the starts of empty
    segments too."""
    keys, min_s, max_s, tpa, want_s, want_l, want_b = _plain_segments(case)
    starts, lens, bounds = _host_segments(host, keys, min_s, max_s, tpa)
    np.testing.assert_array_equal(bounds, want_b)
    np.testing.assert_array_equal(starts, want_s)
    np.testing.assert_array_equal(lens, want_l)
    # the last bound (of K) is where the invalid entries start
    assert bounds[0] == 0
    assert bounds[-1] == int((keys != binning.INVALID_KEY).sum())


def test_host_build_spread_and_codes_equal_morton(host):
    """The 32-bit spread on every 10-bit address, and the codes of
    random, extreme and diagonal addresses, equal ops/morton.py's."""
    from mlsgpu_tpu_torch.ops import morton
    lib = host
    x = np.arange(1024)
    got = np.array([lib.host_spread(int(v)) for v in x], np.int64)
    np.testing.assert_array_equal(
        got, morton._part1by2(torch.as_tensor(x)).numpy())
    rng = np.random.default_rng(3)
    xyz = np.concatenate([rng.integers(0, 1024, (4000, 3)),
                          np.array([[0, 0, 0], [1023, 1023, 1023],
                                    [1023, 0, 0], [0, 1023, 0], [0, 0, 1023]]),
                          np.repeat(x[:, None], 3, axis=1)])
    got = np.array([lib.host_morton(*(int(v) for v in row)) for row in xyz],
                   np.int64)
    t = torch.as_tensor(xyz)
    np.testing.assert_array_equal(
        got, morton.encode(t[:, 0], t[:, 1], t[:, 2]).numpy())


def test_host_build_level_table_equals_level_offsets(host):
    """BinShape's level table and the node count, for every pair of
    shifts the kernels take, equal binning.level_offsets and its end, and
    every node key and boundary fits 31 bits."""
    lib = host
    out = np.empty(11, np.int32)
    pairs = 0
    for min_s in range(3, 14):
        for max_s in range(min_s, 14):
            nodes = lib.host_level_offsets(min_s, max_s, _ptr(out))
            want = binning.level_offsets(min_s, max_s)
            np.testing.assert_array_equal(out[:len(want)], want)
            assert nodes == binning.node_count(min_s, max_s)
            assert nodes == int(want[-1]) + 1 < 1 << 31
            pairs += 1
    assert pairs == 66


def test_host_build_tile_nodes_equal_the_plain_queries(host):
    """Each (tile, level)'s node from the gather equals the plain query
    (tile_segments' node keys) at every level, for tiles a power of two
    an axis and fewer: through keys that are the node keys themselves,
    each node's bound is its rank."""
    for min_s, max_s, tpa in ((3, 7, 16), (4, 6, 4), (3, 5, 3)):
        keys = np.arange(binning.node_count(min_s, max_s), dtype=np.int64)
        starts, lens, _ = _host_segments(host, keys, min_s, max_s, tpa)
        want_s, want_l = binning.tile_segments(torch.as_tensor(keys), min_s,
                                               max_s, tpa)
        np.testing.assert_array_equal(starts, want_s.numpy())
        np.testing.assert_array_equal(lens, want_l.numpy())
        assert (lens == 1).all()


# --- the radix sort -----------------------------------------------------------

#: sort_case's key sets: (levels, kind, entries): one pass at 3 levels,
#: two at 4 and 6, three at 7, four at 9 and 11. "mixed" is node keys of
#: every level with a third invalid, "valid" none invalid, "invalid" all,
#: "ties" three distinct keys, "splats" the keys of edge_cloud("sphere"),
#: "one_digit" every key of one digit in the first pass (multiples of
#: 256), "spread" every low digit in every warp's 512 keys. 4,096 keys
#: make a tile of the sort's passes: the sizes hold one tile, a tile and
#: one key either side, several tiles and a last short one, and a group
#: of 16 tiles (the two-level look-back's, csrc/scan.cuh) and one more
#: tile, two groups and one more.
SORT_CASES = {
    "l3_mixed": (3, "mixed", 20000),
    "l4_mixed": (4, "mixed", 9000),
    "l6_mixed": (6, "mixed", 3 * 4096 + 1),
    "l6_valid": (6, "valid", 4096),
    "l6_below_a_tile": (6, "mixed", 4095),
    "l6_above_a_tile": (6, "mixed", 4097),
    "l6_invalid": (6, "invalid", 9001),
    "l6_ties": (6, "ties", 10000),
    "l6_one_digit": (6, "one_digit", 3 * 4096 + 7),
    "l6_spread": (6, "spread", 2 * 4096 + 512),
    "l6_splats": (6, "splats", None),
    "l6_group_and_a_tile": (6, "mixed", 16 * 4096 + 1),
    "l7_mixed": (7, "mixed", 20011),
    "l7_two_groups_and_a_tile": (7, "mixed", 32 * 4096 + 1),
    "l9_mixed": (9, "mixed", 20000),
    "l11_mixed": (11, "mixed", 20000),
    "empty": (6, "mixed", 0),
    "one": (6, "mixed", 1),
}


def sort_case(case):
    """(int64 keys, min_shift, max_shift) of a SORT_CASES entry, from a
    numpy seed; min_shift 3."""
    return sort_keys_of(*SORT_CASES[case])


def sort_keys_of(levels, kind, m):
    """sort_case's keys of `kind` at `levels` levels, m of them."""
    min_s, max_s = 3, levels + 2
    if kind == "splats":
        splats, valid, origin = edge_cloud("sphere")
        keys = binning.splat_keys(torch.as_tensor(splats),
                                  torch.as_tensor(valid), origin, min_s,
                                  max_s).numpy()
        return keys, min_s, max_s
    rng = np.random.default_rng(levels * 1000 + (m or 0))
    top = binning.node_count(min_s, max_s)
    if kind == "ties":
        keys = rng.choice(np.array([7, top - 1, binning.INVALID_KEY]), m)
    elif kind == "one_digit":
        keys = 256 * rng.integers(0, top // 256, size=m)
    elif kind == "spread":
        keys = (np.arange(m) * 37 % 256
                + 256 * rng.integers(0, top // 256, size=m))
    else:
        keys = rng.integers(0, top, size=m)
        if kind == "mixed":
            keys[rng.random(m) < 1 / 3] = binning.INVALID_KEY
        elif kind == "invalid":
            keys[:] = binning.INVALID_KEY
    return keys.astype(np.int64), min_s, max_s


@pytest.mark.parametrize("levels", range(1, 12))
def test_host_build_sort_plan_is_the_plain_digits(host, levels):
    """binning.cuh's digit plan, its INVALID_KEY -> K map and back, and
    the scratch size, built for the host, are binning.sort_digits',
    binning.node_count's and binning_cuda.sort_scratch_words' at every
    shift range of `levels` levels the wrapper takes (1 to 11)."""
    for min_s in range(3, 14 - levels + 1):
        max_s = min_s + levels - 1
        shift = np.zeros(4, np.int32)
        bits = np.zeros(4, np.int32)
        top = ctypes.c_uint()
        passes = host.host_sort_plan(min_s, max_s, _ptr(shift), _ptr(bits),
                                     ctypes.addressof(top))
        digits = binning.sort_digits(min_s, max_s)
        k = binning.node_count(min_s, max_s)
        assert list(zip(shift[:passes].tolist(), bits[:passes].tolist())) \
            == digits
        k = binning.node_count(min_s, max_s)
        assert top.value == k
        assert sum(b for _, b in digits) == k.bit_length() <= 31
        keys = np.array([0, k // 2, k - 1, binning.INVALID_KEY], np.int64)
        mapped = np.empty(4, np.uint32)
        back = np.empty(4, np.int64)
        host.host_sort_map(_ptr(keys), 4, k, _ptr(mapped), _ptr(back))
        assert mapped.tolist() == [0, k // 2, k - 1, k]
        np.testing.assert_array_equal(back, keys)
        for n in (1, 4096, 4097, 663496):
            assert host.host_sort_scratch_words(n, min_s, max_s) == \
                binning_cuda.sort_scratch_words(n, min_s, max_s)


def test_scan_words_round_trip(host):
    """scan.cuh's status words (a 2-bit flag over a 62-bit value) give
    back their flag and value, the largest values too."""
    for flag in (0, 1, 2):
        for value in (0, 1, 4096, (1 << 31) - 1, 1 << 40, (1 << 62) - 1):
            w = host.host_scan_word(flag, value)
            assert w >> 62 == flag
            assert host.host_scan_flag(w) == flag
            assert host.host_scan_value(w) == value


@pytest.mark.parametrize("words,want", [
    # (flag, value) of the nearest predecessors first; (taken, sum, done)
    ([(2, 5)], (1, 5, True)),
    ([(1, 3), (1, 4), (2, 10)], (3, 17, True)),
    ([(1, 3), (0, 0), (2, 10)], (1, 3, False)),
    ([(0, 0), (2, 10)], (0, 0, False)),
    ([(1, 1)] * 8, (8, 8, False)),
    ([(1, 2), (2, 3), (1, 100)], (2, 5, True)),
])
def test_window_step_takes_aggregates_up_to_an_inclusive_prefix(host, words,
                                                                 want):
    """A look-back round adds its predecessors' aggregates up to the first
    inclusive prefix, and stops before an empty word."""
    arr = np.array([(f << 62) | v for f, v in words], np.uint64)
    total = ctypes.c_ulonglong(0)
    done = ctypes.c_int(0)
    taken = host.host_window_step(_ptr(arr), len(arr),
                                  ctypes.addressof(total),
                                  ctypes.addressof(done))
    assert (taken, total.value, bool(done.value)) == want


#: The two-level look-back's group (csrc/scan.cuh's SCAN_GROUP).
GROUP = binning_cuda.SCAN_GROUP


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("tiles", [1, GROUP - 1, GROUP, GROUP + 1,
                                   2 * GROUP + 1, 11 * GROUP + 3])
def test_two_level_lookback_is_the_exclusive_scan(host, tiles, descending):
    """The two-level look-back on the host (every tile published first:
    its count word and its group's sum) gives each tile the exclusive
    prefix of the counts: in ticket order (a group's first tile meets the
    group below's published prefix: one round), or from the last (the
    groups' first tiles first, each walking every group sum below it, 8 a
    round), every other tile from its group's prefix and its lower tiles'
    counts."""
    rng = np.random.default_rng(tiles)
    counts = rng.integers(0, 4097, size=tiles).astype(np.uint32)
    counts[rng.random(tiles) < 0.2] = 0
    excl = np.empty(tiles, np.uint64)
    rounds = np.empty(tiles, np.int32)
    assert host.host_grouped_scan(_ptr(counts), tiles, int(descending),
                                  _ptr(excl), _ptr(rounds)) == 0
    want = np.concatenate([[0], np.cumsum(counts.astype(np.uint64))[:-1]])
    np.testing.assert_array_equal(excl, want)
    g = np.arange(tiles) // GROUP
    first = (np.arange(tiles) % GROUP == 0) & (g > 0)
    assert (rounds[~first] == 0).all()
    want_rounds = -(-g // 8) if descending else np.ones_like(g)
    np.testing.assert_array_equal(rounds[first], want_rounds[first])


def test_passes_of_one_wave_take_the_two_level_lookback(host):
    """radix_sort.cuh's sort_grouped: a pass of at most 256 tiles (the
    sort's 162-190 at 256^3) takes the two-level look-back, a larger one
    (757-1,180 at 512^3) the decoupled look-back; binning_cuda's scratch
    follows it."""
    for tiles in (1, 162, 190, 256, 257, 757, 1180):
        assert host.host_sort_grouped(tiles) == int(
            tiles <= binning_cuda.SORT_GROUPED_TILES)


def test_group_words_need_every_tile_or_the_prefix(host):
    """A group's sum counts for a look-back only once all SCAN_GROUP tiles
    have added theirs: as an aggregate, or with the group's published
    exclusive prefix (one more than the prefix) as an inclusive prefix;
    group 0's prefix is 0 without a word."""
    add = lambda c: (1 << 24) + c  # noqa: E731
    full = sum(add(c) for c in range(GROUP))
    part = full - add(GROUP - 1)
    agg, incl = 1 << 62, 2 << 62
    total = sum(range(GROUP))
    assert host.host_group_status(0, full, 0) == agg | total
    assert host.host_group_status(1001, full, 0) == incl | (1000 + total)
    assert host.host_group_status(0, full, 1) == incl | total
    for x, first in ((0, 0), (1001, 0), (0, 1)):
        assert host.host_group_status(x, part, first) == 0
        assert host.host_group_status(x, 0, first) == 0


@pytest.mark.parametrize("levels,per_key", [(6, 40), (7, 56)])
def test_sort_rows_give_the_passes_floor(levels, per_key):
    """chip_smoke's sort rows keep their bound (the int64 keys in, keys
    and permutation out: 24 bytes an entry) and add the passes' floor:
    the first pass 8 bytes in and 8 out, a pass between 8 and 8, the last
    8 in and 16 out (int64 keys and permutation); and the weld's passes'
    row, 4-byte keys at 256^3: 4 in and 8 out, then 8 and 8."""
    import chip_smoke
    n = 82_937
    passes = len(binning.sort_digits(3, levels + 2))
    for name in ("bin_sort", "bin_sort_pass"):
        b = chip_smoke.binning_bound(name, n, 1, levels, passes=passes)
        assert b["bytes"] == 24 * 8 * n
        assert b["passes_floor"]["bytes"] == per_key * 8 * n
        assert b["passes_floor"]["ms"] > b["bound_ms"]
    w = chip_smoke.mesh_bound("weld_sort_pass", 256, 0, 776_917, 0, 0, 0, 3)
    assert w["bytes"] == 12 * 776_917
    assert w["passes_floor"]["bytes"] == (12 + 16 + 16) * 776_917


@pytest.mark.parametrize("lookback", ["launcher", "decoupled", "two_level"])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("case", list(SORT_CASES))
def test_host_build_sort_equals_torch_sort(host, case, descending, lookback):
    """The sort's kernels run on the host tile by tile (their ranking a
    warp at a time, the look-back, the staging and the write-out) give
    torch.sort(stable=True)'s keys and permutation, with the look-back
    the launcher picks and with each of the two forced (the decoupled one,
    every tile walking every aggregate below it from the last; the
    two-level one, every group's first tile walking every group sum below
    it from the last); the tiles looked back in ticket order and in
    reverse."""
    keys, min_s, max_s = sort_case(case)
    want_k, want_p = torch.sort(torch.as_tensor(keys), stable=True)
    got_k = np.empty(len(keys), np.int64)
    got_p = np.empty(len(keys), np.int64)
    mode = {"launcher": -1, "decoupled": 0, "two_level": 1}[lookback]
    passes = host.host_sort(_ptr(keys), len(keys), min_s, max_s,
                            int(descending), mode, _ptr(got_k), _ptr(got_p))
    assert passes >= 0, "a tile read an unpublished word"
    assert passes == len(binning.sort_digits(min_s, max_s))
    np.testing.assert_array_equal(got_k, want_k.numpy())
    np.testing.assert_array_equal(got_p, want_p.numpy())


@pytest.mark.parametrize("case", list(SORT_CASES))
def test_sort_keys_on_cpu_is_the_plain_radix_sort(case):
    """On a CPU tensor sort_keys is binning.radix_sort and launches
    nothing; both are torch.sort(stable=True)'s keys and permutation."""
    keys, min_s, max_s = sort_case(case)
    k = torch.as_tensor(keys)
    before = launches.counts()
    got_k, got_p = binning_cuda.sort_keys(k, min_s, max_s)
    assert launches.counts() == before
    want_k, want_p = torch.sort(k, stable=True)
    for got, want in ((got_k, want_k), (got_p, want_p)):
        assert got.dtype == torch.int64
        assert torch.equal(got, want)


@pytest.mark.parametrize("levels", [6, 7])
def test_card_binning_estimate_counts_the_sorts_buffers(levels):
    """pipeline/resources.py's `binning` on the card: the larger of the
    sort's buffers (the int64 keys, sorted keys and permutation, the int32
    keys and indices between passes, its scratch) and the gather's (the
    sorted keys, permutation, row indices and rows), each as the caching
    allocator may count it; on the CPU torch.sort's figure as before."""
    from mlsgpu_tpu_torch.pipeline import resources
    from mlsgpu_tpu_torch.tools import cloud
    cfg = cloud.bench_config(0.03, levels)
    e = 8 * cfg.max_device_splats
    min_s, max_s = cfg.subsampling, levels + cfg.subsampling - 1

    def block(nbytes):
        b = -(-nbytes // 512) * 512
        return b + (1 << 20 if b > 1 << 20 else 0)

    sort = (3 * block(8 * e) + block(8 * e)
            + block(8 * binning_cuda.sort_scratch_words(e, min_s, max_s)))
    gather = 3 * block(8 * e) + block(32 * e)
    card = resources.estimate_block_usage(cfg, "codes", "cuda")
    assert card["binning"] == max(sort, gather) == gather
    cpu = resources.estimate_block_usage(cfg, "codes", "cpu")
    assert cpu["binning"] == e * 64


# --- the wrappers, the build and the counters --------------------------------

def test_no_splats_on_cpu():
    splats = torch.zeros((0, 8), dtype=torch.float32)
    b = binning_cuda.bin_splats(splats, torch.zeros(0, dtype=torch.bool),
                                (0, 0, 0), 3, 5)
    assert b.entry_data.shape == (0, 8) and b.entry_keys.shape == (0,)
    assert b.entry_vals.shape == (0,)
    s, ln = binning_cuda.tile_segments(b.entry_keys, 3, 5, 4)
    assert s.shape == ln.shape == (64, 3)
    assert int(s.abs().sum()) == int(ln.abs().sum()) == 0


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segments_and_bounds_on_cpu_are_the_plain_versions(case):
    """On CPU tensors the segments and their table are the plain
    tile_segments and node_bounds, and nothing is launched."""
    keys, min_s, max_s, tpa, want_s, want_l, want_b = _plain_segments(case)
    before = launches.counts()
    s, ln, b = binning_cuda.segments_and_bounds(torch.as_tensor(keys),
                                                min_s, max_s, tpa)
    assert launches.counts() == before
    for got, want in ((s, want_s), (ln, want_l), (b, want_b)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_event_ms_means_each_kernel_over_its_events():
    """The kernels-alone time of a trace (tools/bench_binning, chip_smoke):
    each named kernel's mean over its kernel events, summed; host events
    of the same name do not count, and a trace that lost a kernel's events
    (fewer than one a call) is not measured."""
    from mlsgpu_tpu_torch.tools.bench_binning import kernel_event_ms
    events = [
        {"ph": "X", "cat": "kernel", "dur": 4.0,
         "name": "(anonymous namespace)::tile_bounds_kernel(long long)"},
        {"ph": "X", "cat": "kernel", "dur": 6.0, "name": "tile_bounds_kernel"},
        {"ph": "X", "cat": "kernel", "dur": 2.0,
         "name": "tile_segments_kernel"},
        {"ph": "X", "cat": "kernel", "dur": 1.0,
         "name": "tile_segments_kernel"},
        {"ph": "X", "cat": "cpu_op", "dur": 90.0,
         "name": "tile_segments_kernel"},
        {"ph": "i", "cat": "kernel", "name": "tile_bounds_kernel"}]
    names = ("tile_bounds_kernel", "tile_segments_kernel")
    assert kernel_event_ms(events, names, 2) == pytest.approx(0.0065)
    assert kernel_event_ms(events, ("tile_bounds_kernel",), 2) == \
        pytest.approx(0.005)
    # three calls traced, two events kept: not measured
    assert kernel_event_ms(events, names, 3) is None
    assert kernel_event_ms(events[:3], names, 2) is None
    assert kernel_event_ms(events, ("bin_keys_kernel",), 2) is None


@pytest.mark.parametrize("call", ["splat_keys", "entry_rows", "bin_splats",
                                  "tile_segments", "segments_and_bounds",
                                  "sort_keys"])
def test_wrappers_raise_for_a_device_they_cannot_take(call):
    splats, valid, origin = edge_cloud("sphere")
    sp = torch.as_tensor(splats).to("meta")
    va = torch.as_tensor(valid).to("meta")
    args = {"splat_keys": (sp, va, origin, 3, 5),
            "entry_rows": (sp, torch.empty(8 * len(splats),
                                           dtype=torch.int64, device="meta")),
            "bin_splats": (sp, va, origin, 3, 5),
            "tile_segments": (torch.empty(8, dtype=torch.int64,
                                          device="meta"), 3, 5, 4),
            "segments_and_bounds": (torch.empty(8, dtype=torch.int64,
                                                device="meta"), 3, 5, 4),
            "sort_keys": (torch.empty(8, dtype=torch.int64, device="meta"),
                          3, 5)
            }[call]
    with pytest.raises(ValueError, match="meta"):
        getattr(binning_cuda, call)(*args)


def test_one_nvcc_call_builds_the_binning_kernels(tmp_path, monkeypatch):
    """One nvcc command for sm_90a names the five sources; the library
    is rebuilt when a header (binning.cuh, marching.cuh, marching_tables.h,
    mesh.cuh, radix_sort.cuh, scan.cuh), which no command line names, is
    newer."""
    cmd = mls_cuda.build_command(["nvcc"], "lib.so")
    assert [os.path.basename(a) for a in cmd if a.endswith(".cu")] == [
        "mls_field.cu", "seam_moments.cu", "binning.cu", "marching.cu",
        "mesh.cu"]
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert [os.path.basename(h) for h in mls_cuda.HEADERS] == [
        "binning.cuh", "marching.cuh", "marching_tables.h", "mesh.cuh",
        "radix_sort.cuh", "scan.cuh"]
    assert all(os.path.isfile(h) for h in mls_cuda.HEADERS)
    log = tmp_path / "calls.log"
    stub = tmp_path / "stub.py"
    stub.write_text(textwrap.dedent(f"""
        import sys
        with open({str(log)!r}, "a") as f:
            f.write("call\\n")
        open(sys.argv[sys.argv.index("-o") + 1], "wb").write(b"lib")
    """))
    monkeypatch.setenv("MLSGPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    header = tmp_path / "binning.cuh"
    header.write_text("// a header\n")
    monkeypatch.setattr(mls_cuda, "HEADERS", [str(header)])
    compiler = [sys.executable, str(stub)]
    target = mls_cuda.build(compiler=compiler)
    mls_cuda.build(compiler=compiler)                  # fresh: no call
    t = os.path.getmtime(target) + 10
    os.utime(header, (t, t))
    mls_cuda.build(compiler=compiler)                  # the header changed
    assert log.read_text().splitlines() == ["call", "call"]


def test_launch_counts_add_up():
    saved = launches.counts()
    try:
        launches.add({"bin_keys": 2, "bin_entries": 3, "tile_bounds": 6,
                      "tile_segments": 4, "bin_sort_histogram": 1,
                      "bin_sort_pass": 2})
        for name in BINNING:
            launches.count(name)
        assert launches.since(saved) == {**dict.fromkeys(launches.KERNELS, 0),
                                         "bin_keys": 3, "bin_entries": 4,
                                         "tile_bounds": 7,
                                         "tile_segments": 5,
                                         "bin_sort_histogram": 2,
                                         "bin_sort_pass": 3}
        with pytest.raises(KeyError):
            launches.add({"keys": 1})
        assert launches.counts()["bin_keys"] == saved["bin_keys"] + 3
    finally:
        launches.reset()
        launches.add(saved)


class CountingStep:
    """The staged block step, which also counts one launch of each binning
    kernel per block (the CPU path launches none)."""

    def __call__(self, *args, **kw):
        for name in BINNING:
            launches.count(name)
        return block_step_staged(*args, **kw)


def test_worker_processes_carry_binning_launches_back():
    """Two worker processes count their blocks' binning launches; the run's
    statistics (`binning.keyLaunches`, `entryLaunches`, `boundLaunches`,
    `segmentLaunches`, `sortHistogramLaunches`, `sortPassLaunches`) and
    this process's counts each gain one a block."""
    from mlsgpu_tpu_torch.pipeline import reconstruct as trec
    from mlsgpu_tpu_torch.pipeline import streamer
    from mlsgpu_tpu_torch.utils.statistics import get_registry
    from tests.test_torch_multidevice import CPU, _bounded, _setup

    cfg, source, info, buckets = _setup()
    buckets = buckets[:4]
    _, readback = trec.prepare_run(cfg, "cpu")
    saved = launches.counts()
    get_registry().clear()
    try:
        got, err = _bounded(lambda: list(streamer.stream_blocks(
            source, info, buckets, cfg, [CPU] * 2, readback,
            read_images=False, step=CountingStep())))
        counts = _since(saved)
    finally:
        launches.reset()
        launches.add(saved)
    assert err is None, err
    assert len(got) == len(buckets)
    stats = get_registry().to_dict()
    assert stats["workers.spawned"]["total"] == 2
    assert counts == [len(buckets)] * len(BINNING)
    for name in ("keyLaunches", "entryLaunches", "boundLaunches",
                 "segmentLaunches", "sortHistogramLaunches",
                 "sortPassLaunches"):
        assert stats[f"binning.{name}"]["total"] == len(buckets), name


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the binning kernels have no CPU "
                    "mode)")
    return torch.device("cuda", 0)


def _same(got, ref, label):
    if got.dtype == torch.float32:
        got, ref = got.view(torch.int32), ref.view(torch.int32)
    assert got.shape == ref.shape and torch.equal(got, ref), label


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS + ("fuzz",))
def test_kernels_bit_for_bit_on_card(cuda_device, kind):
    splats, valid, origin = _fuzz() if kind == "fuzz" else edge_cloud(kind)
    sp = torch.as_tensor(splats, device=cuda_device)
    va = torch.as_tensor(valid, device=cuda_device)
    for min_s, max_s in ((3, 5), (3, 8), (5, 6)):
        tpa = 1 << (max_s - 3)
        before = launches.counts()
        keys = binning_cuda.splat_keys(sp, va, origin, min_s, max_s)
        _same(keys, binning.splat_keys(sp, va, origin, min_s, max_s), "keys")
        _, perm = torch.sort(keys, stable=True)
        data, vals = binning_cuda.entry_rows(sp, perm)
        ref_data, ref_vals = binning.entry_rows(sp, perm)
        _same(vals, ref_vals, "entry_vals")
        _same(data, ref_data, "entry_data")
        b = binning_cuda.bin_splats(sp, va, origin, min_s, max_s)
        s, ln = binning_cuda.tile_segments(b.entry_keys, min_s, max_s, tpa)
        ref_s, ref_l = binning.tile_segments(b.entry_keys, min_s, max_s,
                                             tpa)
        _same(s, ref_s, "starts")
        _same(ln, ref_l, "lens")
        passes = len(binning.sort_digits(min_s, max_s))
        assert _since(before) == [2, 2, 1, 1, 1, passes]
        s, ln, bounds = binning_cuda.segments_and_bounds(b.entry_keys, min_s,
                                                         max_s, tpa)
        _same(bounds, binning.node_bounds(b.entry_keys, min_s, max_s),
              "bounds")
        _same(s, ref_s, "starts (segments_and_bounds)")
        _same(ln, ref_l, "lens (segments_and_bounds)")
        ref = binning.bin_splats(sp, va, origin, min_s, max_s)
        for name in ("entry_keys", "entry_vals", "entry_data"):
            _same(getattr(b, name), getattr(ref, name), name)


@pytest.mark.cuda
def test_no_splats_on_card(cuda_device):
    before = launches.counts()
    b = binning_cuda.bin_splats(
        torch.zeros((0, 8), dtype=torch.float32, device=cuda_device),
        torch.zeros(0, dtype=torch.bool, device=cuda_device), (0, 0, 0), 3,
        5)
    s, ln = binning_cuda.tile_segments(b.entry_keys, 3, 5, 4)
    assert b.entry_data.shape == (0, 8) and s.shape == (64, 3)
    assert int(s.abs().sum()) == int(ln.abs().sum()) == 0
    assert _since(before) == [0, 0, 1, 1, 0, 0]


@pytest.mark.cuda
def test_block_field_launches_each_kernel_once_on_card(cuda_device):
    """One launch of each binning kernel a block, the sort's pass kernel
    once a digit (one digit at 3 levels)."""
    splats, valid, origin = edge_cloud("sphere")
    before = launches.counts()
    block.block_field(torch.as_tensor(splats, device=cuda_device),
                      torch.as_tensor(valid, device=cuda_device),
                      (31, 31, 31), origin, 0.0, levels=3, subsampling=3)
    assert _since(before) == [1, 1, 1, 1, 1, 1]


@pytest.mark.cuda
def test_kernel_path_raises_on_what_it_cannot_take(cuda_device):
    splats, valid, origin = edge_cloud("sphere")
    sp = torch.as_tensor(splats, device=cuda_device)
    va = torch.as_tensor(valid, device=cuda_device)
    with pytest.raises(TypeError):
        binning_cuda.splat_keys(sp.double(), va, origin, 3, 5)
    with pytest.raises(ValueError, match="aligned"):
        binning_cuda.splat_keys(sp.reshape(-1)[1:8 * 100 + 1].reshape(100, 8),
                                va[:100], origin, 3, 5)
    with pytest.raises(ValueError, match="shifts"):
        binning_cuda.splat_keys(sp, va, origin, 2, 5)
    keys = binning_cuda.splat_keys(sp, va, origin, 3, 5)
    with pytest.raises(ValueError, match="tiles an axis"):
        binning_cuda.tile_segments(keys, 3, 5, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_kernels_bit_for_bit_on_edge_cases_on_card(cuda_device,
                                                           case):
    """The bounds and segment kernels against the plain versions on
    segment_case's keys: m = 0, all invalid, only the root, every leaf, the
    last leaf, long runs, a sparse 7-level block."""
    keys, min_s, max_s, tpa, want_s, want_l, want_b = _plain_segments(case)
    k = torch.as_tensor(keys, device=cuda_device)
    before = launches.counts()
    s, ln, b = binning_cuda.segments_and_bounds(k, min_s, max_s, tpa)
    assert _since(before) == [0, 0, 1, 1, 0, 0]
    for got, want, label in ((b, want_b, "bounds"), (s, want_s, "starts"),
                             (ln, want_l, "lens")):
        assert torch.equal(got.cpu(), torch.as_tensor(want)), label


#: The sort's card cases: (levels, kind, keys) as sort_keys_of makes them
#: (one key, a tile of the passes (4,096 keys) and one key either side, a
#: group of the two-level look-back (16 tiles) and one key either side,
#: two groups and a tile, a prime count, 4 to 11 levels (two to four
#: passes), all keys invalid, heavy ties, every key of one digit, every
#: digit in every warp), and
#: the densest bucket of the 2M bench cloud at 6 levels (256^3 corners,
#: 663,496 entries) and at 7 (512^3, 3,098,216).
CARD_SORT_CASES = [
    (6, "mixed", 1), (6, "mixed", 4095), (6, "mixed", 4096),
    (6, "mixed", 4097), (6, "mixed", 16 * 4096 - 1),
    (6, "mixed", 16 * 4096 + 1), (7, "mixed", 32 * 4096 + 1),
    (6, "one_digit", 100_003), (6, "spread", 100_352),
    (6, "mixed", 999_983), (7, "mixed", 999_983),
    (7, "mixed", 4097), (8, "mixed", 999_983), (9, "mixed", 999_983),
    (11, "mixed", 999_983), (4, "mixed", 50_000), (6, "invalid", 100_003),
    (6, "ties", 300_007), (7, "valid", 5 * 4096), (6, "bucket", None),
    (7, "bucket", None)]


def bucket_keys(levels, dev):
    """The key kernel's keys of the densest bucket of the 2M bench cloud
    at `levels` levels (tools/cloud.py), and the shifts."""
    from mlsgpu_tpu_torch.io.splat_set import SequenceSource
    from mlsgpu_tpu_torch.pipeline.streamer import load_bucket
    from mlsgpu_tpu_torch.tools import cloud
    pts, sr = cloud.make_cloud(2_000_000)
    src = SequenceSource(pts)
    cfg = cloud.bench_config(sr, levels)
    info, _, b = cloud.densest_bucket(src, cfg)
    grid_form, valid = load_bucket(src, info, b)
    min_s, max_s = cfg.subsampling, levels + cfg.subsampling - 1
    keys = binning_cuda.splat_keys(
        torch.as_tensor(grid_form, device=dev),
        torch.as_tensor(valid, device=dev),
        tuple(int(v) for v in b.cell_lo), min_s, max_s)
    return keys, min_s, max_s, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("levels,kind,m", CARD_SORT_CASES)
def test_sort_bit_for_bit_on_card(cuda_device, levels, kind, m):
    """sort_keys' kernels give torch.sort(stable=True)'s keys and
    permutation bit for bit, and binning.radix_sort's on the card: one
    histogram launch and one pass launch a digit."""
    if kind == "bucket":
        keys, min_s, max_s, _ = bucket_keys(levels, cuda_device)
    else:
        k, min_s, max_s = sort_keys_of(levels, kind, m)
        keys = torch.as_tensor(k, device=cuda_device)
    before = launches.counts()
    got_k, got_p = binning_cuda.sort_keys(keys, min_s, max_s)
    assert _since(before)[4:] == [1, len(binning.sort_digits(min_s, max_s))]
    want_k, want_p = torch.sort(keys, stable=True)
    plain_k, plain_p = binning.radix_sort(keys, min_s, max_s)
    torch.cuda.synchronize()
    for got, want, label in ((got_k, want_k, "keys"), (got_p, want_p, "perm"),
                             (got_k, plain_k, "keys (plain)"),
                             (got_p, plain_p, "perm (plain)")):
        assert got.dtype == torch.int64 and torch.equal(got, want), label


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [6, 7])
def test_binning_estimate_holds_the_stage_on_card(cuda_device, levels):
    """pipeline/resources.py's `binning` estimate for the card, at the
    densest bucket's splat count, holds what binning_cuda.bin_splats
    allocates on that bucket (torch.cuda.max_memory_allocated above its
    splats) at 256^3 and 512^3."""
    import dataclasses
    from mlsgpu_tpu_torch.io.splat_set import SequenceSource
    from mlsgpu_tpu_torch.pipeline import resources
    from mlsgpu_tpu_torch.pipeline.streamer import load_bucket
    from mlsgpu_tpu_torch.tools import cloud
    pts, sr = cloud.make_cloud(2_000_000)
    src = SequenceSource(pts)
    cfg = cloud.bench_config(sr, levels)
    info, _, b = cloud.densest_bucket(src, cfg)
    grid_form, valid = load_bucket(src, info, b)
    sp = torch.as_tensor(grid_form, device=cuda_device)
    va = torch.as_tensor(valid, device=cuda_device)
    usage = resources.estimate_block_usage(
        dataclasses.replace(cfg, max_device_splats=len(grid_form)), "codes",
        "cuda")
    min_s, max_s = cfg.subsampling, levels + cfg.subsampling - 1
    torch.cuda.synchronize(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    out = binning_cuda.bin_splats(sp, va, tuple(int(v) for v in b.cell_lo),
                                  min_s, max_s)
    torch.cuda.synchronize(cuda_device)
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert out.entry_keys.numel() == 8 * len(grid_form)
    assert 0 < peak <= usage["binning"]
