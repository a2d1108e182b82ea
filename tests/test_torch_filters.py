"""Mesh filters in the port: `DeviceScaleBias` / `DeviceFilterChain`
against the JAX package's on the same vertices (bitwise), and end to end
on the CPU: a device bias shifts the output (mirrors
tests/test_pipeline.py:461-488), a device scale is one global affine map,
origin-independent across blocks, equal to the unfiltered output
transformed on the host within 1e-5 of a cell (mirrors :491-520), and the
host `filters=` hook gives the device filter's output. A device filter
makes the readback raw, so the runs it is compared with read back raw
too: their vertices then come in the same order (the codes mode's host
weld numbers them in another)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mlsgpu_tpu.pipeline import mesh_filter as jfilter
from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.io import ply
from mlsgpu_tpu_torch.io.splat_set import SequenceSource
from mlsgpu_tpu_torch.pipeline import mesh_filter, reconstruct as trec
from mlsgpu_tpu_torch.utils.manifold import check_manifold
from mlsgpu_tpu_torch.utils.statistics import get_registry

from tests import oracle

SCALE, BIAS = 2.0, (1.5, -2.0, 0.25)     # bias in grid cells


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def splats():
    return oracle.sphere_cloud(np.zeros(3), 3.0, 8000, 0.35,
                               np.random.default_rng(9))


def config(readback="raw") -> ReconstructConfig:
    return ReconstructConfig(fit_grid=0.1, fit_smooth=1.0, levels=4,
                             subsampling=3, leaf_cells=8,
                             max_device_splats=200000, tile_candidates=512,
                             readback=readback, progress=False)


def run(path, readback="raw", **kw):
    get_registry().clear()
    trec.reconstruct(SequenceSource(splats()), config(readback), str(path),
                     device="cpu", **kw)
    return ply.read_mesh(str(path)), get_registry().to_dict()


class Recorder:
    """A host filter that keeps a copy of each block's global grid
    vertices and changes nothing."""

    def __init__(self):
        self.blocks = []

    def __call__(self, vertices, triangles):
        self.blocks.append(vertices.copy())
        return vertices, triangles


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    rec = Recorder()
    (v, t), _ = run(tmp_path_factory.mktemp("plain") / "plain.ply",
                    filters=rec)
    return v, t, rec.blocks


@pytest.fixture(scope="module")
def scaled(tmp_path_factory):
    chain = mesh_filter.DeviceFilterChain(
        [mesh_filter.DeviceScaleBias(scale=SCALE, bias=BIAS)])
    rec = Recorder()
    (v, t), stats = run(tmp_path_factory.mktemp("scaled") / "scaled.ply",
                        device_filter=chain, filters=rec)
    assert stats["readback.mode.raw"]["total"] == stats["bucket.count"][
        "total"] > 1
    return v, t, rec.blocks


def test_device_scale_bias_matches_jax():
    rng = np.random.default_rng(5)
    verts = (rng.random((1000, 3)) * 64).astype(np.float32)
    origin = (64, 128, 192)
    filters = [(2.0, (1.5, -2.0, 0.25)), (0.37, (0.0, 0.0, 0.0)),
               (1.0, (-3.0, 5.5, 7.0))]
    jchain = jfilter.DeviceFilterChain(
        [jfilter.DeviceScaleBias(s, b) for s, b in filters])
    chain = mesh_filter.DeviceFilterChain(
        [mesh_filter.DeviceScaleBias(s, b) for s, b in filters])
    ref = np.asarray(jchain(jnp.asarray(verts), jnp.asarray(origin)))
    got = chain(torch.as_tensor(verts), origin).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_device_filter_bias_end_to_end(plain, tmp_path):
    chain = mesh_filter.DeviceFilterChain(
        [mesh_filter.DeviceScaleBias(bias=(5.0, 0.0, 0.0))])
    # --readback packed is overridden: the filter needs raw arrays
    (v2, t2), stats = run(tmp_path / "shifted.ply", readback="packed",
                          device_filter=chain)
    assert "readback.mode.packed" not in stats
    v1, t1, _ = plain
    assert len(v1) == len(v2) and len(t1) == len(t2)
    # 5 cells * 0.1 spacing = 0.5 world units in x
    np.testing.assert_allclose(np.sort(v2[:, 0]), np.sort(v1[:, 0]) + 0.5,
                               atol=1e-4)


def test_device_filter_scale_is_origin_independent(plain, scaled):
    """One global affine map, the same for every block: each block's
    filtered vertices, in global grid coordinates as the mesher receives
    them, are its unfiltered vertices mapped through scale * g + bias on
    the host, within 1e-5 of a cell; the output is manifold and closed."""
    (v1, t1, b1), (v2, t2, b2) = plain, scaled
    np.testing.assert_array_equal(t1, t2)
    rep = check_manifold(v2, t2)
    assert rep.is_manifold and rep.num_boundary_edges == 0, rep.reason
    assert len(b1) == len(b2) > 1
    for g1, g2 in zip(b1, b2):
        expect = SCALE * g1.astype(np.float64) + np.asarray(BIAS)
        np.testing.assert_allclose(g2, expect, rtol=0, atol=1e-5)


def test_host_filters_hook_equals_device_filter(scaled, tmp_path):
    """reconstruct(filters=...) runs the port's host chain on each block's
    global grid coordinates: the same map as the device filter."""
    chain = mesh_filter.MeshFilterChain(
        [mesh_filter.ScaleBiasFilter(SCALE, BIAS)])
    (v3, t3), _ = run(tmp_path / "host.ply", filters=chain)
    v2, t2, _ = scaled
    np.testing.assert_array_equal(t3, t2)
    np.testing.assert_allclose(v3, v2, rtol=0, atol=1e-5 * 0.1)
