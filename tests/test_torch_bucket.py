"""Bucketing in the port (pipeline/bucket.py: the dense path copied, the
sparse path on ops/morton.py's numpy Morton code) against the JAX
package's: the Morton codes bitwise, the same buckets (regions, blob ids,
skeletons, chunks) on the dense path and, with MAX_MICRO_GRID lowered in
both packages, on the sparse one, and one end-to-end run over an extent of
more than 512 microblocks per axis."""

import numpy as np
import pytest
import torch

from mlsgpu_tpu.io import splat_set as jsplat_set
from mlsgpu_tpu.ops import morton as jmorton
from mlsgpu_tpu.pipeline import blobs as jblobs
from mlsgpu_tpu.pipeline import bucket as jbucket
from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.io import ply
from mlsgpu_tpu_torch.io.splat_set import SequenceSource
from mlsgpu_tpu_torch.ops import morton
from mlsgpu_tpu_torch.pipeline import blobs as blobs_mod
from mlsgpu_tpu_torch.pipeline import bucket, reconstruct as trec
from mlsgpu_tpu_torch.utils.manifold import check_manifold
from mlsgpu_tpu_torch.utils.statistics import get_registry

from tests import oracle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_morton_np_bitwise_equal_jax():
    rng = np.random.default_rng(2)
    xyz = rng.integers(0, 1 << 21, size=(3, 5000), dtype=np.int64)
    xyz[:, :3] = [[0, (1 << 21) - 1, 5], [0, (1 << 21) - 1, 0],
                  [0, (1 << 21) - 1, 9]]
    codes = morton.encode_np(*xyz)
    assert codes.dtype == np.uint64
    np.testing.assert_array_equal(codes, jmorton.encode_np(*xyz))
    for a, b, c in zip(morton.decode_np(codes), jmorton.decode_np(codes),
                       xyz):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def two_spheres(gap: float, n: int = 3000) -> np.ndarray:
    rng = np.random.default_rng(17)
    return np.concatenate([
        oracle.sphere_cloud(np.zeros(3), 2.0, n, 0.35, rng),
        oracle.sphere_cloud(np.array([gap, 1.0, -0.5]), 2.0, n, 0.35, rng)])


def assert_same_buckets(got, ref):
    assert len(got) == len(ref) > 10
    for a, b in zip(got, ref):
        assert (a.chunk_id.gen, a.chunk_id.coords) == (b.chunk_id.gen,
                                                       b.chunk_id.coords)
        assert a.num_splats == b.num_splats
        np.testing.assert_array_equal(a.cell_lo, b.cell_lo)
        np.testing.assert_array_equal(a.cell_hi, b.cell_hi)
        np.testing.assert_array_equal(a.blob_ids, b.blob_ids)
        np.testing.assert_array_equal(a.skeleton, b.skeleton)


def both_infos(splats):
    """The port's and the JAX package's blob pass over the same splats."""
    return (blobs_mod.compute_blobs(SequenceSource(splats), 0.1, 8),
            jblobs.compute_blobs(jsplat_set.SequenceSource(splats), 0.1, 8))


@pytest.mark.parametrize("max_grid,chunk_cells", [(4, None), (4, 16),
                                                  (2, None)])
def test_make_buckets_equals_jax(monkeypatch, max_grid, chunk_cells):
    """With MAX_MICRO_GRID lowered in both packages the sparse path runs;
    the port's buckets equal the JAX package's."""
    splats = two_spheres(6.0)
    info, jinfo = both_infos(splats)
    dense = jbucket.microblock_counts(jinfo.blobs, jinfo.micro_lo,
                                      jinfo.micro_dims)
    monkeypatch.setattr(jbucket, "MAX_MICRO_GRID", max_grid)
    monkeypatch.setattr(bucket, "MAX_MICRO_GRID", max_grid)
    assert (info.micro_dims > max_grid).any()
    kw = dict(max_splats=400, chunk_cells=chunk_cells)
    assert_same_buckets(bucket.make_buckets(info, 31, 8, **kw),
                        jbucket.make_buckets(jinfo, 31, 8, **kw))
    # the sparse counts are the dense grid's occupied entries
    codes, counts = bucket.sparse_micro_counts(info.blobs, info.micro_lo)
    assert len(codes) == np.count_nonzero(dense)
    np.testing.assert_array_equal(counts, dense[morton.decode_np(codes)])


def test_sparse_extent_end_to_end(tmp_path):
    """Two spheres 450 units apart at a 0.1 grid: more than 512 microblocks
    along x, so bucketing runs sparse; the mesh is manifold, closed, and
    has one component per sphere."""
    splats = two_spheres(450.0)
    cfg = ReconstructConfig(fit_grid=0.1, fit_smooth=1.0, levels=4,
                            subsampling=3, leaf_cells=8,
                            max_device_splats=200000, progress=False)
    info = blobs_mod.compute_blobs(SequenceSource(splats), 0.1,
                                   cfg.micro_cells)
    assert info.micro_dims[0] > bucket.MAX_MICRO_GRID
    out = str(tmp_path / "sparse.ply")
    get_registry().clear()
    assert trec.reconstruct(SequenceSource(splats), cfg, out,
                            device="cpu") == [out]
    verts, tris = ply.read_mesh(out)
    rep = check_manifold(verts, tris)
    assert rep.is_manifold, rep.reason
    assert rep.num_boundary_edges == 0 and rep.num_components == 2
    for center in (np.zeros(3), np.array([450.0, 1.0, -0.5])):
        r = np.linalg.norm(verts - center, axis=1)
        near = r < 3.0
        assert near.sum() > 500 and abs(np.median(r[near]) - 2.0) < 0.08
