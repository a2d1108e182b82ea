"""The three readback modes of the port's block step, and
--statistics-device.

One block (`__graft_entry__._example_inputs`, as tests/test_torch_block.py)
through the port's `block_step` with readback "codes", "packed" and "raw":
the same welded counts, the same triangles and external keys, and positions
within 2e-5 of a cell of the raw (unquantized) ones — one t16 quantum
(1/65535) and float noise. Against the JAX package's
`block_step_body(readback="packed")` on the same inputs, with
tests/test_torch_block.py's tolerance: counts within max(n // 500, 8).
End to end, `statistics_device` gives the same mesh as the plain run and
records every stage (mirrors tests/test_pipeline.py:378-400)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _example_inputs
from mlsgpu_tpu.ops.block import block_step_body
from mlsgpu_tpu.ops.block import pack_format as jax_pack_format
from mlsgpu_tpu_torch import _native as nat
from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.convert import block_inputs_from_numpy
from mlsgpu_tpu_torch.io import ply
from mlsgpu_tpu_torch.io.splat_set import SequenceSource
from mlsgpu_tpu_torch.ops import block
from mlsgpu_tpu_torch.pipeline import reconstruct as trec
from mlsgpu_tpu_torch.utils.manifold import check_manifold
from mlsgpu_tpu_torch.utils.statistics import get_registry

from tests import oracle

LEVELS = 4
CAPS = dict(max_candidates=1024, cell_cap=1 << 15, vertex_cap=1 << 17,
            index_cap=3 << 17)
STAGES = ("binning", "segments", "mls", "faces", "skeleton", "marching",
          "weld", "pack")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    splats, valid, region, origin = _example_inputs(4096, LEVELS)
    origin = origin + np.array([64, 0, 128], np.int32)   # a non-zero block
    splats = splats.copy()
    splats[:, 0:3] += origin.astype(np.float32)
    return splats, valid, region, origin


def host_mesh(result, region, origin):
    """(vertices global f32, triangles, external keys, first external) of a
    port BlockResult in any readback mode."""
    c = result.counts
    org = origin.astype(np.int64)
    if result.readback == "codes":
        v, t, k, fe = nat.rebuild_block(
            result.packed.numpy().view(np.uint32), c[4], c[5], c[2],
            result.fmt.nc_axis, org, region.astype(np.int64))
        return v, t, k, fe
    fe = result.first_external
    if result.readback == "packed":
        v, t, k = block.unpack_readback_global(
            result.packed.numpy().view(np.uint32), c[2], c[0], fe,
            result.fmt, org)
        return v, t, k, fe
    m = result.mesh
    hi, lo = m.key_hi[fe:].numpy(), m.key_lo[fe:].numpy()
    return (m.vertices.numpy() + org.astype(np.float32),
            m.triangles.numpy(), ((hi & 0x7FFFFFFF) << 32) | lo, fe)


@pytest.fixture(scope="module")
def port_modes(inputs):
    splats, valid, region, origin = inputs
    kw = block_inputs_from_numpy(splats, valid, region, origin)
    out = {}
    for mode in block.READBACK_MODES:
        r = block.block_step(**kw, boundary_factor=0.0, levels=LEVELS,
                             subsampling=3, readback=mode)
        assert r.readback == mode
        out[mode] = (r, host_mesh(r, region, origin))
    return out


def test_modes_same_counts(port_modes):
    codes, packed, raw = (port_modes[m][0] for m in block.READBACK_MODES)
    assert np.array_equal(packed.counts, raw.counts)
    for i in (2, 4, 5, 6):      # indices, cells, unwelded, MLS tiles
        assert codes.counts[i] == packed.counts[i]
    nw = packed.num_vertices
    assert nw > 1000 and codes.num_unwelded > nw
    assert len(port_modes["codes"][1][0]) == nw       # host weld == device
    assert isinstance(packed.fmt, block.PackFormat) and raw.fmt is None
    assert len(packed.packed) == packed.fmt.total_words(
        packed.num_indices, nw)


@pytest.mark.parametrize("mode", ["codes", "packed"])
def test_modes_same_mesh(port_modes, mode):
    """Same triangles and keys as raw, once the vertices are matched
    through the triangles (the host rebuild numbers internal vertices in
    its own order); positions within 2e-5 of a cell."""
    rv, rt, rk, rfe = port_modes["raw"][1]
    v, t, k, fe = port_modes[mode][1]
    assert (len(v), len(t), fe) == (len(rv), len(rt), rfe)
    perm = np.full(len(v), -1)
    perm[t.ravel()] = rt.ravel()
    np.testing.assert_array_equal(perm[t.ravel()], rt.ravel())
    assert len(np.unique(perm)) == len(v) and (perm >= 0).all()
    np.testing.assert_array_equal(perm[fe:], np.arange(fe, len(v)))
    np.testing.assert_array_equal(k, rk)
    np.testing.assert_allclose(v, rv[perm], rtol=0, atol=2e-5)


def test_packed_matches_jax(inputs, port_modes):
    splats, valid, region, origin = inputs
    step = jax.jit(functools.partial(
        block_step_body, levels=LEVELS, subsampling=3, fit_shape="sphere",
        mls_backend="xla", pack_output=True, readback="packed", **CAPS))
    res = step(jnp.asarray(splats), jnp.asarray(valid), jnp.asarray(region),
               jnp.asarray(origin), 0.0)
    jc = np.asarray(res.counts).astype(np.int64)
    assert jc[0] <= CAPS["vertex_cap"] and jc[4] <= CAPS["cell_cap"]
    jfmt = jax_pack_format(LEVELS, 3, CAPS["vertex_cap"])
    jv, jt, _ = nat.unpack_readback(np.asarray(res.packed), int(jc[2]),
                                    int(jc[0]), int(jc[1]), jfmt.index_mode,
                                    jfmt.vertex_words,
                                    origin.astype(np.int64))
    pr, (pv, pt, _, _) = port_modes["packed"]
    for i in (0, 1, 2, 4, 5):
        n = int(jc[i])
        assert n > 1000
        assert abs(int(pr.counts[i]) - n) <= max(n // 500, 8), (i, n)
    for verts, tris in ((jv, jt), (pv, pt)):
        rep = check_manifold(verts, tris)
        assert rep.is_manifold, rep.reason
        assert rep.num_boundary_edges == 0


@pytest.mark.parametrize("device_type, requested, levels, native, want", [
    ("cuda", "auto", LEVELS, True, "packed"),   # the card welds
    ("cuda", "auto", 11, True, "packed"),       # 2^13 corners: packed holds
    ("cuda", "auto", 12, True, "cpu rule"),     # 2^14: packed cannot
    ("cuda", "auto", LEVELS, False, "packed"),
    ("cuda", "codes", LEVELS, True, "codes"),
    ("cuda", "raw", LEVELS, True, "raw"),
    ("cpu", "auto", LEVELS, True, "codes"),
    ("cpu", "auto", LEVELS, False, "packed"),
    ("cpu", "auto", 9, True, "packed"),         # 2^11 corners
    ("cpu", "raw", LEVELS, True, "raw"),
    ("cpu", "bogus", LEVELS, True, ValueError),
    ("cuda", "bogus", LEVELS, True, ValueError),
])
def test_resolve_readback(monkeypatch, device_type, requested, levels,
                          native, want):
    """'auto' is packed on a card wherever the packed layout holds the
    block, and elsewhere the JAX package's rule: codes with the native
    library and flat u32 cell ids, else packed; explicit modes stand."""
    monkeypatch.setattr(nat, "available", lambda: native)
    if want is ValueError:
        with pytest.raises(ValueError):
            block.resolve_readback(requested, levels, 3, device_type)
        return
    if want == "cpu rule":
        want = block.resolve_readback(requested, levels, 3, "cpu")
    assert block.resolve_readback(requested, levels, 3, device_type) == want


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_prepare_run_resolves_by_device_type(monkeypatch, device_type):
    """prepare_run hands the type of the run's devices to the readback
    rule (a card is faked: its resolution and memory check are stubbed)."""
    seen = []

    def rule(*args):
        seen.append(args[-1])
        return block.resolve_readback(*args)

    monkeypatch.setattr(nat, "available", lambda: True)
    monkeypatch.setattr(trec, "require_native", lambda: None)
    monkeypatch.setattr(trec, "resolve_readback", rule)
    monkeypatch.setattr(trec, "resolve_devices",
                        lambda name, n: [torch.device(device_type, 0)])
    monkeypatch.setattr(trec, "validate_device", lambda *a: None)
    cfg = ReconstructConfig(fit_grid=0.1, levels=LEVELS, leaf_cells=8,
                            progress=False)
    devices, readback = trec.prepare_run(cfg, device_type)
    assert [d.type for d in devices] == [device_type]
    assert seen == [device_type]
    assert readback == {"cpu": "codes", "cuda": "packed"}[device_type]


def test_device_filter_needs_raw(inputs):
    from mlsgpu_tpu_torch.pipeline.mesh_filter import DeviceScaleBias
    splats, valid, region, origin = inputs
    kw = block_inputs_from_numpy(splats[:64], valid[:64], region, origin)
    with pytest.raises(ValueError, match="raw"):
        block.block_step(**kw, boundary_factor=0.0, levels=LEVELS,
                         subsampling=3, readback="packed",
                         device_filter=DeviceScaleBias(bias=(1, 0, 0)))


def test_statistics_device_staged_run(tmp_path):
    """statistics_device runs the block step stage by stage and must give
    the same mesh while recording every per-stage device time."""
    splats = oracle.sphere_cloud(np.zeros(3), 3.0, 8000, 0.35,
                                 np.random.default_rng(11))
    cfg = dict(fit_grid=0.1, fit_smooth=1.0, levels=4, subsampling=3,
               leaf_cells=8, max_device_splats=200000, tile_candidates=512,
               readback="packed", progress=False)
    out1 = str(tmp_path / "plain.ply")
    out2 = str(tmp_path / "staged.ply")
    get_registry().clear()
    trec.reconstruct(SequenceSource(splats), ReconstructConfig(**cfg), out1,
                     device="cpu")
    assert not any(k.startswith(f"device.{s}.")
                   for k in get_registry().to_dict() for s in STAGES)
    get_registry().clear()
    trec.reconstruct(SequenceSource(splats),
                     ReconstructConfig(statistics_device=True, **cfg), out2,
                     device="cpu")
    stats = get_registry().to_dict()
    blocks = stats["bucket.count"]["total"]
    for stage in STAGES:
        key = f"device.{stage}.time"
        assert key in stats, f"missing {key} in {sorted(stats)}"
        assert stats[key]["n"] == blocks or stage == "skeleton"
    assert stats["readback.mode.packed"]["total"] == blocks
    v1, t1 = ply.read_mesh(out1)
    v2, t2 = ply.read_mesh(out2)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(t1, t2)
    rep = check_manifold(v2, t2)
    assert rep.is_manifold and rep.num_boundary_edges == 0, rep.reason


def test_codes_without_native_raises(monkeypatch, tmp_path):
    """--readback codes needs the native rebuild: without the library the
    run stops before it starts; 'auto' resolves to packed instead."""
    from mlsgpu_tpu_torch.utils.errors import MlsError
    monkeypatch.setattr(nat, "get_lib", lambda: None)
    splats = oracle.sphere_cloud(np.zeros(3), 3.0, 500, 0.35,
                                 np.random.default_rng(1))
    cfg = ReconstructConfig(fit_grid=0.1, levels=4, leaf_cells=8,
                            readback="codes", progress=False)
    get_registry().clear()
    with pytest.raises(MlsError, match="native host library"):
        trec.reconstruct(SequenceSource(splats), cfg,
                         str(tmp_path / "x.ply"), device="cpu")
    assert "pass0.time" not in get_registry().to_dict()
    assert block.resolve_readback("auto", LEVELS, 3, "cpu") == "packed"
