"""One whole block: the port's `block_step` against the JAX package's
`block_step_body(..., mls_backend="xla", readback="codes")` on the same
inputs (`__graft_entry__._example_inputs`). After the native rebuild both
meshes are manifold and their vertex and triangle counts agree within
max(n // 500, 8): the fields agree to float noise, which can flip a
handful of near-zero corners."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _example_inputs
from mlsgpu_tpu.ops.block import block_step_body, codes_format
from mlsgpu_tpu_torch import _native as nat
from mlsgpu_tpu_torch.convert import block_inputs_from_numpy
from mlsgpu_tpu_torch.ops import block
from mlsgpu_tpu_torch.utils.manifold import check_manifold

LEVELS = 4
CAPS = dict(max_candidates=1024, cell_cap=1 << 15, vertex_cap=1 << 17,
            index_cap=3 << 17)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    splats, valid, region, origin = _example_inputs(4096, LEVELS)
    origin = origin + np.array([64, 0, 128], np.int32)   # a non-zero block
    step = jax.jit(functools.partial(
        block_step_body, levels=LEVELS, subsampling=3, fit_shape="sphere",
        mls_backend="xla", readback="codes", **CAPS))
    splats_g = splats.copy()
    splats_g[:, 0:3] += origin.astype(np.float32)
    res = step(jnp.asarray(splats_g), jnp.asarray(valid), jnp.asarray(region),
               jnp.asarray(origin), 0.0)
    c = np.asarray(res.counts)
    assert c[3] <= CAPS["max_candidates"] and c[4] <= CAPS["cell_cap"]
    assert c[5] <= CAPS["vertex_cap"]
    nc_axis = codes_format(LEVELS, 3).nc_axis
    jax_mesh = nat.rebuild_block(np.asarray(res.packed), c[4], c[5], c[2],
                                 nc_axis, origin.astype(np.int64),
                                 region.astype(np.int64))

    port = block.block_step(**block_inputs_from_numpy(splats_g, valid, region,
                                                      origin),
                            boundary_factor=0.0, levels=LEVELS, subsampling=3)
    pc = block.fetch_counts(port)
    port_mesh = nat.rebuild_block(port.packed.numpy().view(np.uint32),
                                  pc[4], pc[5], pc[2], nc_axis,
                                  origin.astype(np.int64),
                                  region.astype(np.int64))
    return (c, jax_mesh), (pc, port_mesh, port)


def test_block_counts_match_jax(meshes):
    (jc, jm), (pc, pm, _) = meshes
    for i in (0, 2, 4):     # vertices, indices, cells
        n = int(jc[i])
        assert n > 1000
        assert abs(int(pc[i]) - n) <= max(n // 500, 8), (i, pc[i], n)
    assert abs(len(pm[0]) - len(jm[0])) <= max(len(jm[0]) // 500, 8)
    assert abs(len(pm[1]) - len(jm[1])) <= max(len(jm[1]) // 500, 8)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_block_meshes_manifold(meshes, which):
    (_, jm), (_, pm, _) = meshes
    verts, tris = (jm if which == "jax" else pm)[:2]
    rep = check_manifold(verts, tris)
    assert rep.is_manifold, rep.reason
    assert rep.num_boundary_edges == 0      # the sphere lies inside the block


def test_block_result_layout(meshes):
    _, (pc, _, port) = meshes
    assert port.packed.dtype == torch.int32
    assert len(port.packed) == block.CodesFormat(0).total_words(
        port.num_cells, port.num_unwelded)
    assert dict(zip(block.COUNTS_FIELDS, pc.tolist()))["num_occ_tiles"] > 0
    assert pc[3] == 0 and pc[7] == 0        # no caps in the port
