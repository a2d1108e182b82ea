"""End to end on the CPU: the port's `reconstruct(..., device=cpu)` against
the JAX package's `reconstruct` on one small multi-bucket sphere (the
tests/test_reconstruct.py settings), a bitwise port rerun, and checkpoints
— one written by the JAX package resumed by the port, whose mesher reads
the JAX package's classes as its own copies of them."""

import numpy as np
import pytest
import torch

from mlsgpu_tpu import config as jconfig
from mlsgpu_tpu.io import splat_set as jsplat_set
from mlsgpu_tpu.pipeline import reconstruct as jrec
from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.io import ply
from mlsgpu_tpu_torch.io.splat_set import SequenceSource
from mlsgpu_tpu_torch.pipeline import reconstruct as trec
from mlsgpu_tpu_torch.utils.manifold import check_manifold

from tests import oracle

CENTER = np.array([0.7, -0.3, 0.2])
RADIUS = 3.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_config(jax=False, **kw) -> ReconstructConfig:
    """The run's configuration, as the port's ReconstructConfig or (jax)
    the JAX package's."""
    base = dict(fit_grid=0.1, fit_smooth=1.0, fit_prune=0.02,
                levels=3, subsampling=3, leaf_cells=8,     # 32^3-corner blocks
                max_device_splats=200000, tile_candidates=512,
                cell_cap=1 << 15, vertex_cap=1 << 17, index_cap=3 << 17,
                progress=False)
    base.update(kw)
    return (jconfig.ReconstructConfig if jax else ReconstructConfig)(**base)


def sphere_splats(n=20000, sr=0.25, seed=21):
    return oracle.sphere_cloud(CENTER, RADIUS, n, sr,
                               np.random.default_rng(seed))


def check_sphere(path):
    """Manifold and closed, one component, vertices on the sphere (as
    tests/test_reconstruct.py::check_sphere_output)."""
    verts, tris = ply.read_mesh(path)
    assert len(verts) > 500
    rep = check_manifold(verts, tris)
    assert rep.is_manifold, rep.reason
    assert rep.num_boundary_edges == 0
    assert rep.num_components == 1
    assert rep.euler_characteristics == [2]
    r = np.linalg.norm(verts - CENTER, axis=1)
    assert abs(np.median(r) - RADIUS) < 0.08
    assert np.abs(r - RADIUS).max() < 0.25
    return verts, tris


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's run of the sphere: checkpointed, then written by
    its resume (the write path is its own mesher)."""
    d = tmp_path_factory.mktemp("jax")
    ckpt = str(d / "jax.state")
    src = jsplat_set.SequenceSource(sphere_splats())
    assert jrec.reconstruct(src, small_config(jax=True, checkpoint=ckpt),
                            str(d / "unused.ply")) == []
    out = str(d / "jax.ply")
    jrec.resume(ckpt, small_config(jax=True), out)
    return ckpt, out


@pytest.fixture(scope="module")
def port_out(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port") / "port.ply")
    files = trec.reconstruct(SequenceSource(sphere_splats()), small_config(),
                             out, device="cpu")
    assert files == [out]
    return out


def test_port_matches_jax(jax_run, port_out):
    _, jax_out = jax_run
    vj, tj = check_sphere(jax_out)
    vp, tp = check_sphere(port_out)
    assert abs(len(vp) - len(vj)) <= max(len(vj) // 500, 8)
    assert abs(len(tp) - len(tj)) <= max(len(tj) // 500, 16)


def test_port_rerun_bitwise_identical(tmp_path):
    outs = []
    for i in (0, 1):
        out = str(tmp_path / f"run{i}.ply")
        trec.reconstruct(SequenceSource(sphere_splats(6000, sr=0.4)),
                         small_config(levels=4), out, device="cpu")
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]


def test_jax_checkpoint_resumes_under_port(jax_run, tmp_path):
    ckpt, jax_out = jax_run
    out = str(tmp_path / "resumed.ply")
    assert trec.resume(ckpt, small_config(), out) == [out]
    v1, t1 = ply.read_mesh(jax_out)
    v2, t2 = ply.read_mesh(out)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(t1, t2)


def test_port_checkpoint_resume(tmp_path):
    ckpt = str(tmp_path / "port.state")
    src = SequenceSource(sphere_splats(6000, sr=0.4))
    assert trec.reconstruct(src, small_config(levels=4, checkpoint=ckpt),
                            str(tmp_path / "x.ply"), device="cpu") == []
    out = str(tmp_path / "resumed.ply")
    trec.resume(ckpt, small_config(levels=4), out)
    check_sphere(out)
