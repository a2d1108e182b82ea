"""The seam passes: the port's `canonical_face_field` and
`skeleton_point_field` against the JAX package's on the same input field and
(JAX-binned) entries, to the field bar (NaN agreement > 0.9995, |Δ| < 1e-3),
and the port's own seam contract — shared face, T-junction and
chunking-independent corners bitwise equal between two port blocks
(analogues of tests/test_canonical.py:58,87,109,139)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlsgpu_tpu.ops import binning as jbin
from mlsgpu_tpu.ops import mls as jmls
from mlsgpu_tpu_torch.convert import binned_from_numpy, block_inputs_from_numpy
from mlsgpu_tpu_torch.core.chunk import ChunkId
from mlsgpu_tpu_torch.ops import block, kernel_gate, mls
from mlsgpu_tpu_torch.pipeline.bucket import Bucket, skeleton_points

from tests import oracle

LEVELS, SUB = 3, 3
B = 1 << (LEVELS + SUB - 1)   # 32 corners per axis
TPA = B // 8
K = 2304                      # JAX candidate cap: above every tile total here


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bucket(lo, hi):
    return Bucket(chunk_id=ChunkId(gen=0, coords=(0, 0, 0)),
                  cell_lo=np.array(lo, np.int64), cell_hi=np.array(hi, np.int64),
                  blob_ids=np.empty(0, np.int64), num_splats=1)


def _cloud(center, n, seed, radius=9.0):
    rng = np.random.default_rng(seed)
    return oracle.sphere_cloud(center, radius, n, 1.2, rng).astype(np.float32)


def port_field(splats, lo, hi, points=None, **kw):
    """The port's seam-canonical field of block [lo, hi) on the CPU."""
    args = block_inputs_from_numpy(splats, np.ones(len(splats), bool),
                                   np.subtract(hi, lo), lo, points)
    if kw:
        # same passes with non-default chunking
        b = block.binning.bin_splats(args["splats"], args["valid"],
                                     args["cell_origin"], SUB, LEVELS + SUB - 1)
        s, ln = block.binning.tile_segments(b.entry_keys, SUB,
                                            LEVELS + SUB - 1, TPA)
        f = mls.eval_field(b.entry_data, s, ln, args["cell_origin"], TPA,
                           "sphere", 0.0, tile_chunk=kw["tile_chunk"])
        mls.canonical_face_field(f, b.entry_data, b.entry_vals, s, ln,
                                 args["cell_origin"], args["region_cells"],
                                 TPA, "sphere", 0.0, row_chunk=kw["row_chunk"])
        return f.numpy()
    f, _ = block.block_field(**args, boundary_factor=0.0, levels=LEVELS,
                             subsampling=SUB)
    return f.numpy()


def assert_bitwise(pa, pb, min_defined):
    na, nb = np.isnan(pa), np.isnan(pb)
    np.testing.assert_array_equal(na, nb)
    assert (~na).sum() >= min_defined
    np.testing.assert_array_equal(pa[~na].view(np.uint32),
                                  pb[~nb].view(np.uint32))


# --- against the JAX package -------------------------------------------------

_jit_eval = jax.jit(jmls.eval_field, static_argnums=(4, 5, 6, 8))
_jit_faces = jax.jit(jmls.canonical_face_field, static_argnums=(7, 8, 9, 10))
_jit_skeleton = jax.jit(jmls.skeleton_point_field, static_argnums=(7, 8, 9, 10))


def _jax_fields(splats, buckets, fits):
    """JAX interior, face and skeleton fields of each bucket's block."""
    skeleton_points(buckets)
    out = []
    for bk in buckets:
        origin = jnp.asarray(bk.cell_lo.astype(np.int32))
        region = jnp.asarray((bk.cell_hi - bk.cell_lo).astype(np.int32))
        jb = jbin.bin_splats(jnp.asarray(splats), jnp.ones(len(splats), bool),
                             origin, SUB, LEVELS + SUB - 1)
        s, ln = jbin.tile_segments(jb.entry_keys, SUB, LEVELS + SUB - 1, TPA)
        assert int(np.asarray(ln).sum(axis=1).max()) <= K
        fields = {}
        for fit, bf in fits:
            f0, _ = _jit_eval(jb.entry_data, s, ln, origin, TPA, K, fit,
                              jnp.float32(bf), 8)
            ff, fmax = _jit_faces(f0, jb.entry_data, jb.entry_vals, s, ln,
                                  origin, region, TPA, K, fit, bf)
            assert int(fmax) <= K
            fs = _jit_skeleton(ff, jb.entry_data, jb.entry_vals, s, ln, origin,
                               jnp.asarray(bk.skeleton.astype(np.int32)), TPA,
                               K, fit, bf)
            fields[fit] = tuple(np.array(x) for x in (f0, ff, fs))
        out.append((bk, jb, np.array(s), np.array(ln), fields))
    return out


@pytest.fixture(scope="module")
def jax_face_blocks():
    """The two blocks sharing the misaligned plane x = 28."""
    return _jax_fields(_cloud([28.0, 14.0, 14.0], 6000, 42),
                       [_bucket((0, 0, 0), (28, 31, 31)),
                        _bucket((28, 0, 0), (59, 31, 31))],
                       [("sphere", 0.0), ("plane", 0.75)])


@pytest.fixture(scope="module")
def jax_tjunction_blocks():
    """Unequal-extent neighbours whose junction line the surface crosses."""
    return _jax_fields(_cloud([12.0, 12.0, 16.0], 9000, 3, radius=7.0),
                       [_bucket((0, 0, 0), (16, 16, 31)),
                        _bucket((0, 16, 0), (31, 31, 31))],
                       [("sphere", 0.0)])


def _port_passes(bk, jb, s, ln, f0, fit, bf, skeleton):
    b = binned_from_numpy(np.asarray(jb.entry_data), np.asarray(jb.entry_keys),
                          np.asarray(jb.entry_vals))
    st, lt = torch.as_tensor(s), torch.as_tensor(ln)
    f = torch.as_tensor(f0.copy())
    mls.canonical_face_field(f, b.entry_data, b.entry_vals, st, lt,
                             bk.cell_lo, bk.cell_hi - bk.cell_lo, TPA, fit, bf)
    faces = f.numpy().copy()
    if skeleton:
        mls.skeleton_point_field(f, b.entry_data, b.entry_vals, st, lt,
                                 bk.cell_lo, torch.as_tensor(bk.skeleton),
                                 TPA, fit, bf)
    return faces, f.numpy()


@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("fit,bf", [("sphere", 0.0), ("plane", 0.75)])
def test_face_field_matches_jax(jax_face_blocks, side, fit, bf):
    bk, jb, s, ln, fields = jax_face_blocks[side]
    f0, jfaces, _ = fields[fit]
    faces, _ = _port_passes(bk, jb, s, ln, f0, fit, bf, skeleton=False)
    changed = jfaces.view(np.uint32) != f0.view(np.uint32)
    assert changed.sum() > 50          # the pass really rewrote the planes
    summary = kernel_gate.compare_fields(torch.as_tensor(jfaces),
                                         torch.as_tensor(faces))
    kernel_gate.check(summary, min_defined=1000)


@pytest.mark.parametrize("side", [0, 1])
def test_skeleton_field_matches_jax(jax_tjunction_blocks, side):
    bk, jb, s, ln, fields = jax_tjunction_blocks[side]
    f0, _, jskel = fields["sphere"]
    _, skel = _port_passes(bk, jb, s, ln, f0, "sphere", 0.0, skeleton=True)
    pts = bk.skeleton - bk.cell_lo
    got = skel[pts[:, 2], pts[:, 1], pts[:, 0]]
    ref = jskel[pts[:, 2], pts[:, 1], pts[:, 0]]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    assert fin.sum() >= 4          # the surface crosses the skeleton
    np.testing.assert_allclose(got[fin], ref[fin], atol=1e-3)


# --- the port's own seam contract --------------------------------------------

@pytest.mark.parametrize("region_a", [28, 24])   # 28 % 8 != 0: misaligned
def test_shared_face_plane_bitwise_equal(region_a):
    splats = _cloud([region_a, 14.0, 14.0], 6000, 42)
    fa = port_field(splats, (0, 0, 0), (region_a, B - 1, B - 1))
    fb = port_field(splats, (region_a, 0, 0), (region_a + B - 1, B - 1, B - 1))
    assert_bitwise(fa[:, :, region_a], fb[:, :, 0], 100)


def test_shared_face_bitwise_equal_across_chunking():
    """The port's analogue of the JAX cap-growth case: blocks whose passes
    run with different tile and row chunkings (so different slot widths and
    chunk compositions) still agree bitwise on the shared plane."""
    splats = _cloud([24.0, 14.0, 14.0], 6000, 42)
    fa = port_field(splats, (0, 0, 0), (24, B - 1, B - 1),
                    tile_chunk=32, row_chunk=32)
    fb = port_field(splats, (24, 0, 0), (24 + B - 1, B - 1, B - 1),
                    tile_chunk=5, row_chunk=7)
    assert_bitwise(fa[:, :, 24], fb[:, :, 0], 100)


def test_face_pass_preserves_interior_consistency():
    """Face values are still a valid MLS evaluation: compare with the
    float64 oracle at the x = 0 face."""
    splats = _cloud([2.0, 14.0, 13.0], 8000, 7)
    f = port_field(splats, (0, 0, 0), (B - 1, B - 1, B - 1))
    plane = f[:, :, 0]
    zz, yy = np.nonzero(~np.isnan(plane))
    assert len(zz) > 50
    corners = np.stack([np.zeros_like(zz), yy, zz], axis=1).astype(np.float64)
    expect = oracle.mls_field_bruteforce(splats.astype(np.float64), corners)
    got = plane[zz, yy]
    finite = np.isfinite(expect)
    assert finite.mean() > 0.9
    np.testing.assert_allclose(got[finite], expect[finite], rtol=2e-4,
                               atol=2e-4)


def test_t_junction_edge_bitwise_equal():
    """Unequal-extent neighbours (a T-junction): every shared corner,
    including the junction line, bitwise equal across all three blocks."""
    splats = _cloud([12.0, 12.0, 16.0], 9000, 3, radius=7.0)
    a = _bucket((0, 0, 0), (16, 16, 31))
    c = _bucket((16, 0, 0), (31, 16, 31))
    bk = _bucket((0, 16, 0), (31, 31, 31))
    skeleton_points([a, c, bk])
    sb = bk.skeleton
    assert ((sb[:, 0] == 16) & (sb[:, 1] == 16)).sum() == 32
    fa, fc, fb = (port_field(splats, x.cell_lo, x.cell_hi, x.skeleton)
                  for x in (a, c, bk))
    assert_bitwise(fa[:, 16, 0:17], fb[:, 0, 0:17], 20)
    assert_bitwise(fc[:, 16, 0:16], fb[:, 0, 16:32], 20)
    assert_bitwise(fa[:, 0:17, 16], fc[:, 0:17, 0], 20)
    assert np.isfinite(fa[:, 16, 16]).sum() >= 2
