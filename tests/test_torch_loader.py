"""The loader's host work (pipeline/streamer.py::load_bucket) against the
JAX package's:
- `bucket_ranges`, merged in numpy, against the JAX package's loop
  (`mlsgpu_tpu.io.splat_set.merge_ranges` over the same blobs): the same
  ranges in the same order, on made blob sets with overlapping, adjacent,
  nested, duplicate and empty ranges, and on every bucket of a seeded
  cloud;
- the PLY decode of a bucket-sized read on its default threads (the
  process's cores, at most one per 64K rows) against one thread, bit for
  bit;
- the conversion of a block's splats (core/splat.py::block_inputs)
  against the JAX package's expressions (its SplatArray.to_grid_frame with
  the radius in cells, and is_finite): the same bits, on random splats and
  on edge values (NaN and infinities in every field, zero, negative and
  subnormal radii, huge values, signed zeros), over grids with negative
  and positive extents.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from mlsgpu_tpu.core.grid import Grid as JGrid
from mlsgpu_tpu.core.splat import SplatArray as JSplatArray
from mlsgpu_tpu.io.splat_set import merge_ranges
from mlsgpu_tpu_torch import _native
from mlsgpu_tpu_torch.core.grid import Grid
from mlsgpu_tpu_torch.core.splat import block_inputs
from mlsgpu_tpu_torch.io.splat_set import SequenceSource
from mlsgpu_tpu_torch.pipeline import blobs, bucket, streamer

from tests import oracle


def merged(info, b):
    start, count = info.blobs.start, info.blobs.count
    return merge_ranges((int(start[i]), int(start[i] + count[i]))
                        for i in b.blob_ids)


def made(seed, n):
    """n blobs of 0-6 splats starting anywhere in [0, 40): overlaps,
    adjacency, nesting, duplicates and empty ranges; a random subset in a
    random order as the bucket's blobs."""
    rng = np.random.default_rng(seed)
    blob = SimpleNamespace(start=rng.integers(0, 40, n),
                           count=rng.integers(0, 7, n))
    ids = rng.permutation(n)[:rng.integers(0, n + 1)]
    return SimpleNamespace(blobs=blob), SimpleNamespace(blob_ids=ids)


@pytest.mark.parametrize("seed", range(12))
def test_made_blobs_merge_as_the_loop(seed):
    info, b = made(seed, [0, 1, 2, 5, 30, 200][seed % 6])
    got = streamer.bucket_ranges(info, b)
    assert got == merged(info, b)
    assert all(type(v) is int for r in got for v in r)


def test_every_bucket_of_a_cloud():
    splats = oracle.sphere_cloud(np.array([0.7, -0.3, 0.2]), 2.5, 6000, 0.3,
                                 np.random.default_rng(3))
    info = blobs.compute_blobs(SequenceSource(splats), 0.1, 8)
    buckets = bucket.make_buckets(info, 31, 8, max_splats=1500)
    assert len(buckets) > 4
    for b in buckets:
        assert streamer.bucket_ranges(info, b) == merged(info, b)


GRIDS = [((0.0, 0.0, 0.0), 1.0, [(0, 64)] * 3),
         ((-50.5, -20.25, 3.125), 0.0371, [(-800, 900), (-3, 5), (10, 20)]),
         ((1e4, -1e4, 0.1), 7.5, [(-2, 2)] * 3)]


def splats(seed, n=5000):
    rng = np.random.default_rng(seed)
    out = (rng.standard_normal((n, 8)) * rng.choice([1e-3, 1, 1e3, 1e6],
                                                    (n, 8))).astype(np.float32)
    out[:, 3] = np.abs(out[:, 3])
    edge = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45,
                     3.4e38, -3.4e38], np.float32)
    rows = rng.choice(n, n // 4, replace=False)
    cols = rng.integers(0, 8, len(rows))
    out[rows, cols] = rng.choice(edge, len(rows))
    out[rng.choice(n, 50), 3] = -1.0
    return out


def reference(sp, g):
    jg = JGrid.make(*g)
    arr = JSplatArray(sp)
    out = arr.to_grid_frame(jg)
    out[:, 3] = sp[:, 3] / np.float32(jg.spacing)
    return out, arr.is_finite()


@pytest.mark.parametrize("grid", range(len(GRIDS)))
@pytest.mark.parametrize("seed", [1, 2])
def test_block_inputs_bits_equal_jax(grid, seed):
    sp = splats(seed)
    g = GRIDS[grid]
    with np.errstate(all="ignore"):   # the edge values overflow
        got, valid = block_inputs(sp, Grid.make(*g))
        want, want_valid = reference(sp, g)
    assert got.dtype == np.float32 and valid.dtype == np.bool_
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(valid, want_valid)
    assert 0 < valid.sum() < len(sp)


def test_empty_block():
    got, valid = block_inputs(np.zeros((0, 8), np.float32),
                              Grid.make(*GRIDS[1]))
    assert got.shape == (0, 8) and valid.shape == (0,)


def test_bucket_decode_threads_bits_equal_one_thread():
    if not _native.available():
        pytest.skip(f"native library unavailable: {_native.last_error}")
    rng = np.random.default_rng(4)
    n, stride = 200_000, 28
    raw = rng.integers(0, 256, n * stride, dtype=np.uint8)
    rec = raw.reshape(n, stride).view(np.uint8)
    rec[:, 24:28] = np.frombuffer(
        (rng.random(n, dtype=np.float32) + 0.1).tobytes(), np.uint8
    ).reshape(n, 4)                                   # positive radii
    offsets = np.array([0, 4, 8, 12, 16, 20, 24], np.int64)
    one = _native.decode_splats(raw.tobytes(), n, stride, offsets, 1.5, 0.9,
                                nthreads=1)
    auto = _native.decode_splats(raw.tobytes(), n, stride, offsets, 1.5,
                                 0.9)
    assert one.tobytes() == auto.tobytes()
