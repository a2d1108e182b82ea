"""parallel/sharded.py of the port against the JAX package's on the same
inputs: tests/test_parallel.py's two tests through both packages.

`distributed_cell_bounds`: lo and hi within rtol 1e-6 of the JAX package's
and of numpy, the count equal. `data_parallel_block_step`: one z-slab block
per mesh entry; per block the welded vertex, index and external counts
against the JAX package's (its fields differ by float noise, which can flip
a handful of near-zero corners: each count within max(n // 500, 8), the
bar of tests/test_torch_block.py), each block bitwise the same block
through `block_step` alone, and the welded whole a closed manifold of one
component with Euler characteristic 2. A mesh on the CPU repeats the CPU
device, as the JAX tests' mesh is 8 virtual CPU devices."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlsgpu_tpu.parallel import sharded as jsharded
from mlsgpu_tpu_torch.core.chunk import ChunkId
from mlsgpu_tpu_torch.core.grid import Grid
from mlsgpu_tpu_torch.io.ply import read_mesh
from mlsgpu_tpu_torch.ops.block import block_step, readback_tensors
from mlsgpu_tpu_torch.parallel.sharded import (data_parallel_block_step,
                                               distributed_cell_bounds,
                                               make_mesh)
from mlsgpu_tpu_torch.pipeline.mesher import BlockInput, OOCMesher
from mlsgpu_tpu_torch.utils.errors import InvalidOption
from mlsgpu_tpu_torch.utils.manifold import check_manifold

from tests import oracle

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs the JAX package's multi-device mesh")

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_mesh():
    assert make_mesh([CPU, "cpu"]) == [CPU, CPU]
    with pytest.raises(ValueError):
        make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(InvalidOption):   # no card: never the CPU instead
            make_mesh()


def test_distributed_cell_bounds_matches_jax_and_numpy():
    d = len(jax.devices())
    rng = np.random.default_rng(3)
    pos = rng.uniform(-5, 5, size=(d, 100, 3)).astype(np.float32)
    r = rng.uniform(0.1, 1.0, size=(d, 100)).astype(np.float32)
    valid = rng.random((d, 100)) < 0.7
    jlo, jhi, jcnt = jsharded.distributed_cell_bounds(
        jsharded.make_mesh(), jnp.asarray(pos), jnp.asarray(r),
        jnp.asarray(valid))
    lo, hi, cnt = distributed_cell_bounds(
        make_mesh([CPU] * d), torch.as_tensor(pos), torch.as_tensor(r),
        torch.as_tensor(valid))
    assert lo.shape == hi.shape == (3,) and cnt.shape == ()
    np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), rtol=1e-6)
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), rtol=1e-6)
    assert int(cnt) == int(jcnt) == valid.sum()
    pos_f = pos.reshape(-1, 3)[valid.reshape(-1)]
    r_f = r.reshape(-1)[valid.reshape(-1)]
    np.testing.assert_allclose(lo.numpy(), (pos_f - r_f[:, None]).min(0),
                               rtol=1e-6)
    np.testing.assert_allclose(hi.numpy(), (pos_f + r_f[:, None]).max(0),
                               rtol=1e-6)
    # numpy arrays are taken as they are, and a shard may be all invalid
    valid[0] = False
    lo2, hi2, cnt2 = distributed_cell_bounds(make_mesh([CPU] * d), pos, r,
                                             valid)
    assert int(cnt2) == valid.sum()
    sel = valid.reshape(-1)
    np.testing.assert_allclose(
        lo2.numpy(), (pos.reshape(-1, 3)[sel]
                      - r.reshape(-1)[sel][:, None]).min(0), rtol=1e-6)


def _slabs(d):
    """tests/test_parallel.py's input: a sphere in a 31 x 31 x (d * 15)
    cell volume, one z-slab of 15 cells per mesh entry."""
    rng = np.random.default_rng(4)
    slab_cells = 15
    total_z = d * slab_cells
    center = np.array([15.0, 15.0, total_z / 2.0])
    radius = min(12.0, total_z / 2.0 - 2.5)
    n = 1000 * d
    splats = oracle.sphere_cloud(center, radius, n, 2.5, rng)
    npad = 1 << int(np.ceil(np.log2(n)))
    sp = np.zeros((d, npad, 8), np.float32)
    sp[:, :, 3] = 1.0
    va = np.zeros((d, npad), bool)
    regions = np.zeros((d, 3), np.int32)
    origins = np.zeros((d, 3), np.int32)
    for i in range(d):
        z0 = i * slab_cells
        sel = ((splats[:, 2] + splats[:, 3] >= z0)
               & (splats[:, 2] - splats[:, 3] < z0 + slab_cells))
        k = int(sel.sum())
        sp[i, :k] = splats[sel]
        va[i, :k] = True
        regions[i] = (31, 31, slab_cells)
        origins[i] = (0, 0, z0)
    return sp, va, regions, origins, total_z


def test_data_parallel_blocks_weld_and_match_jax(tmp_path):
    d = len(jax.devices())
    sp, va, regions, origins, total_z = _slabs(d)
    jres = jsharded.data_parallel_block_step(
        jsharded.make_mesh(), jnp.asarray(sp), jnp.asarray(va),
        jnp.asarray(regions), jnp.asarray(origins), 0.0,
        levels=3, subsampling=3, max_candidates=2048,
        cell_cap=1 << 14, vertex_cap=1 << 16, index_cap=3 << 16)

    mesh = make_mesh([CPU] * d)
    results = data_parallel_block_step(
        mesh, torch.as_tensor(sp), torch.as_tensor(va), regions, origins,
        0.0, levels=3, subsampling=3, readback="raw")
    assert len(results) == d

    grid = Grid.make((0, 0, 0), 1.0, [(0, 31), (0, 31), (0, total_z)])
    mesher = OOCMesher(grid, prune=0.0)
    for i, res in enumerate(results):
        for name in ("num_vertices", "num_indices", "first_external"):
            got, want = getattr(res, name), int(getattr(jres, name)[i])
            assert abs(got - want) <= max(want // 500, 8), (i, name, got, want)
        # the sharded call is bitwise the block step alone
        alone = block_step(torch.as_tensor(sp[i]), torch.as_tensor(va[i]),
                           tuple(int(v) for v in regions[i]),
                           tuple(int(v) for v in origins[i]), 0.0,
                           levels=3, subsampling=3, readback="raw")
        np.testing.assert_array_equal(res.counts, alone.counts)
        for a, b in zip(readback_tensors(res), readback_tensors(alone)):
            assert torch.equal(a, b)
        m, fe = res.mesh, res.first_external
        keys = ((m.key_hi[fe:] & 0x7FFFFFFF) << 32) | m.key_lo[fe:]
        mesher.add(BlockInput(
            ChunkId(gen=i),
            m.vertices.numpy() + origins[i].astype(np.float32), fe,
            keys.numpy(), m.triangles.to(torch.int32).numpy()))
    assert sum(r.num_vertices for r in results) > 1000

    out = os.path.join(str(tmp_path), "dp.ply")
    mesher.write(out)
    verts, tris = read_mesh(out)
    rep = check_manifold(verts, tris)
    assert rep.is_manifold, rep.reason
    assert rep.num_boundary_edges == 0
    assert rep.num_components == 1
    assert rep.euler_characteristics == [2]
    mesher.cleanup()


def test_a_failing_entry_raises_after_all_ended():
    sp, va, regions, origins, _ = _slabs(2)
    with pytest.raises(ValueError, match="unknown readback"):
        data_parallel_block_step(make_mesh([CPU] * 2), sp, va, regions,
                                 origins, 0.0, levels=3, subsampling=3,
                                 readback="nonsense")
    with pytest.raises(ValueError, match="mesh entries"):
        data_parallel_block_step(make_mesh([CPU] * 3), sp, va, regions,
                                 origins, 0.0, levels=3, subsampling=3)
