"""Marching codes: given the same field, the port's cell ids, case codes,
t16 and counts are bitwise equal to the JAX package's
`generate(emit="codes")` (tile-major compaction order included), the packed
codes image is bitwise equal as u32 words, and the native rebuild gives
identical meshes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlsgpu_tpu.ops import marching as jmarch
from mlsgpu_tpu.ops.block import _pack_codes
from mlsgpu_tpu_torch import _native as nat
from mlsgpu_tpu_torch.ops import block, marching
from mlsgpu_tpu_torch.utils.manifold import check_manifold

CAPS = dict(cell_cap=1 << 14, vertex_cap=1 << 16, index_cap=3 << 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sphere_field(b, center, radius):
    g = np.arange(b, dtype=np.float64)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    d = np.sqrt((xx - center[0]) ** 2 + (yy - center[1]) ** 2
                + (zz - center[2]) ** 2) - radius
    return d.astype(np.float32)


def _fields():
    closed = sphere_field(32, (15.5, 15.3, 15.8), 9.0)
    # surface leaving the block, NaN holes, region smaller than the block
    open_ = sphere_field(40, (30.0, 12.0, 20.0), 14.0)
    rng = np.random.default_rng(4)
    holes = rng.random(open_.shape) < 0.01
    open_[holes] = np.nan
    return {"closed": (closed, (31, 31, 31), (0, 0, 0)),
            "open": (open_, (35, 39, 30), (64, 32, 8))}


FIELDS = _fields()


def _both(name):
    field, region, origin = FIELDS[name]
    cm = jmarch.generate(jnp.asarray(field), jnp.asarray(region, jnp.int32),
                         jnp.asarray(origin, jnp.int32), **CAPS, emit="codes")
    assert int(cm.num_cells) <= CAPS["cell_cap"]
    assert int(cm.num_vertices) <= CAPS["vertex_cap"]
    tc = marching.generate_codes(torch.as_tensor(field), region)
    return cm, tc


@pytest.mark.parametrize("name", ["closed", "open"])
def test_codes_bitwise_equal_jax(name):
    cm, tc = _both(name)
    nc, nv = int(cm.num_cells), int(cm.num_vertices)
    assert (tc.num_cells, tc.num_vertices, tc.num_indices) == (
        nc, nv, int(cm.num_indices))
    assert nc > 300
    np.testing.assert_array_equal(tc.cell_ids.numpy(),
                                  np.asarray(cm.cell_ids)[:nc].astype(np.int64))
    np.testing.assert_array_equal(tc.cell_codes.numpy(),
                                  np.asarray(cm.cell_codes)[:nc].astype(np.int64))
    np.testing.assert_array_equal(tc.t16.numpy(),
                                  np.asarray(cm.t16)[:nv].astype(np.int64))


def _images(name):
    cm, tc = _both(name)
    jflat = np.asarray(jax.jit(_pack_codes, static_argnums=(1, 2))(
        cm, CAPS["cell_cap"], CAPS["vertex_cap"]))
    img = block.pack_codes(tc).numpy().view(np.uint32)
    return cm, tc, jflat, img


@pytest.mark.parametrize("name", ["closed", "open"])
def test_pack_codes_bitwise_u32(name):
    cm, tc, jflat, img = _images(name)
    fmt = block.CodesFormat(nc_axis=FIELDS[name][0].shape[0] - 1)
    assert len(img) == fmt.total_words(tc.num_cells, tc.num_vertices)
    np.testing.assert_array_equal(img, jflat[:len(img)])


@pytest.mark.parametrize("name", ["closed", "open"])
def test_native_rebuild_identical(name):
    if not nat.available():
        pytest.fail("native library unavailable: the codes path needs it")
    field, region, origin = FIELDS[name]
    cm, tc, jflat, img = _images(name)
    args = (tc.num_cells, tc.num_vertices, tc.num_indices, field.shape[0] - 1,
            np.asarray(origin, np.int64), np.asarray(region, np.int64))
    a = nat.rebuild_block(jflat, *args)
    b = nat.rebuild_block(img, *args)
    np.testing.assert_array_equal(a[0].view(np.uint32), b[0].view(np.uint32))
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    assert a[3] == b[3]
    rep = check_manifold(b[0], b[1])
    assert rep.is_manifold, rep.reason
    if name == "closed":
        assert rep.num_boundary_edges == 0


def test_compaction_is_tile_major():
    """Occupied cells come out tile by tile (8^3-cell tiles in (tz, ty, tx)
    order), raster order inside a tile."""
    field, region, _ = FIELDS["closed"]
    tc = marching.generate_codes(torch.as_tensor(field), region)
    ids = tc.cell_ids.numpy()
    nc = field.shape[0] - 1
    cz, cy, cx = ids // (nc * nc), (ids // nc) % nc, ids % nc
    tile = ((cz // 8) * 4 + cy // 8) * 4 + cx // 8
    local = ((cz % 8) * 8 + cy % 8) * 8 + cx % 8
    key = tile * 512 + local
    assert np.all(np.diff(key) > 0)
    assert not np.all(np.diff(ids) > 0)   # not plain raster order
