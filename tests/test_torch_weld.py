"""The device mesh path of the port against the JAX package, bit for bit on
the same fields: `generate_mesh` against `generate(emit="mesh")`, the weld
against `weld.weld`, tiled classification against the dense one and the
JAX package's `_classify_tiled`, and `pack_readback` against
`_pack_readback` in every index mode and vertex layout (with the native
and numpy decoders' round trip). The `cuda` tests hold the card's runs of
the same functions to the CPU's, bit for bit.

jax is imported only inside the JAX-side tests, so the `cuda` tests run
where jax is absent: `python -m pytest --noconftest -m cuda
tests/test_torch_weld.py`.
"""

import numpy as np
import pytest
import torch

from mlsgpu_tpu_torch import _native as nat
from mlsgpu_tpu_torch.ops import block, marching, weld

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
    """name -> (field, region_cells, cell_origin): the fields of
    tests/test_torch_marching.py plus those of tests/test_marching.py's
    tiled-classification tests (a sparse field, 17 cells per axis)."""
    closed = sphere_field(32, (15.5, 15.3, 15.8), 9.0)
    open_ = sphere_field(40, (30.0, 12.0, 20.0), 14.0)
    rng = np.random.default_rng(4)
    open_[rng.random(open_.shape) < 0.01] = np.nan
    holed = sphere_field(24, (11.5, 11.5, 11.5), 8.0)
    holed[:, :, :5] = np.nan
    sparse = np.full((32, 32, 32), np.nan, np.float32)
    sparse[4:12, 4:12, 4:12] = sphere_field(8, (3.5, 3.5, 3.5), 2.5)
    odd = sphere_field(18, (8.5, 8.5, 8.5), 6.0)
    return {"closed": (closed, (31, 31, 31), (0, 0, 0)),
            "open": (open_, (35, 39, 30), (64, 32, 8)),
            "holed": (holed, (23, 23, 23), (3, 5, 7)),
            "sparse": (sparse, (31, 31, 31), (3, 5, 7)),
            "odd": (odd, (17, 17, 17), (3, 5, 7)),
            "cut_region": (closed, (31, 20, 13), (3, 5, 7))}


FIELDS = _fields()


_JAX_MESHES: dict = {}


def _jax_mesh(name):
    """The JAX package's `generate(emit="mesh")` of a field (computed once
    per module)."""
    if name not in _JAX_MESHES:
        import functools

        import jax
        import jax.numpy as jnp
        from mlsgpu_tpu.ops import marching as jmarch
        field, region, origin = FIELDS[name]
        gen = jax.jit(functools.partial(jmarch.generate, **CAPS))
        m = gen(jnp.asarray(field), jnp.asarray(region, jnp.int32),
                jnp.asarray(origin, jnp.int32))
        assert int(m.num_vertices) <= CAPS["vertex_cap"]
        _JAX_MESHES[name] = m
    return _JAX_MESHES[name]


def _port_mesh(name, device="cpu", tiled=None):
    field, region, origin = FIELDS[name]
    return marching.generate_mesh(torch.as_tensor(field, device=device),
                                  region, origin, tiled=tiled)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("name", ["closed", "open"])
def test_generate_mesh_bitwise_equal_jax(name):
    m = _jax_mesh(name)
    t = _port_mesh(name)
    nv, ni = int(m.num_vertices), int(m.num_indices)
    assert nv > 1000
    assert (t.num_cells, t.num_vertices, t.num_indices) == (
        int(m.num_cells), nv, ni)
    np.testing.assert_array_equal(t.vertices.numpy().view(np.uint32),
                                  np.asarray(m.vertices)[:nv].view(np.uint32))
    np.testing.assert_array_equal(t.key_hi.numpy(), _u32(m.key_hi)[:nv])
    np.testing.assert_array_equal(t.key_lo.numpy(), _u32(m.key_lo)[:nv])
    np.testing.assert_array_equal(t.triangles.numpy(),
                                  np.asarray(m.triangles)[:ni // 3])


def _welded(name):
    from mlsgpu_tpu.ops import weld as jweld
    m = _jax_mesh(name)
    jw = jweld.weld(m.vertices, m.key_hi, m.key_lo, m.triangles,
                    m.num_vertices, m.num_indices)
    t = _port_mesh(name)
    return jw, weld.weld(t.vertices, t.key_hi, t.key_lo, t.triangles)


@pytest.mark.parametrize("name", ["closed", "open"])
def test_weld_bitwise_equal_jax(name):
    jw, pw = _welded(name)
    nw = int(jw.num_vertices)
    assert (pw.num_vertices, pw.first_external, pw.num_indices) == (
        nw, int(jw.first_external), int(jw.num_indices))
    if name == "open":       # the surface leaves the region: externals
        assert 0 < pw.first_external < nw
    np.testing.assert_array_equal(pw.vertices.numpy().view(np.uint32),
                                  np.asarray(jw.vertices)[:nw].view(np.uint32))
    np.testing.assert_array_equal(pw.key_hi.numpy(), _u32(jw.key_hi)[:nw])
    np.testing.assert_array_equal(pw.key_lo.numpy(), _u32(jw.key_lo)[:nw])
    np.testing.assert_array_equal(
        pw.triangles.numpy(),
        np.asarray(jw.triangles)[:pw.num_indices // 3])


def test_weld_orders_externals_last_by_key():
    _, pw = _welded("open")
    fe = pw.first_external
    hi, lo = pw.key_hi.numpy(), pw.key_lo.numpy()
    assert not (hi[:fe] >> 31).any() and (hi[fe:] >> 31).all()
    key = (hi << 32) | lo
    assert np.all(np.diff(key[:fe]) > 0) and np.all(np.diff(key[fe:]) > 0)


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_classify_tiled_bitwise(name):
    """Port tiled == port dense == the JAX package's _classify_tiled with a
    tile cap that fits."""
    import jax
    import jax.numpy as jnp
    from mlsgpu_tpu.ops import marching as jmarch
    field, region, _ = FIELDS[name]
    f = torch.as_tensor(field)
    dense = marching.classify_dense(f, region)
    tiled = marching.classify_tiled(f, region)
    for a, b in zip(dense[:3], tiled[:3]):
        assert torch.equal(a, b)
    n = int(dense[0].shape[0])
    assert n > 50
    (iso, code, cx, cy, cz, _, num_cells, _, _, num_tiles) = jax.jit(
        jmarch._classify_tiled, static_argnums=(2, 3))(
            jnp.asarray(field), jnp.asarray(region, jnp.int32),
            CAPS["cell_cap"], 1 << 10)
    assert int(num_cells) == n and int(num_tiles) == tiled[3] <= 1 << 10
    np.testing.assert_array_equal(tiled[0].numpy(), np.asarray(code)[:n])
    np.testing.assert_array_equal(
        tiled[1].numpy(), np.stack([np.asarray(c)[:n] for c in (cx, cy, cz)],
                                   axis=1))
    np.testing.assert_array_equal(tiled[2].numpy().view(np.uint32),
                                  np.asarray(iso)[:n].view(np.uint32))


def test_tiled_selection_rule():
    """Tiled above 2^8 corners per axis, dense at or below (the JAX
    package's default_march_tile_cap rule); both give the same mesh."""
    field, region, origin = FIELDS["sparse"]
    f = torch.as_tensor(field)
    assert marching.classify(f, region)[3] == 0           # 32 corners: dense
    big = torch.full((marching.TILED_ABOVE + 1,) * 3, float("nan"))
    big[:32, :32, :32] = f
    got = marching.classify(big, region)
    assert got[3] > 0                                      # tiled
    assert torch.equal(got[2], marching.classify_dense(f, region)[2])
    codes_t = marching.generate_codes(f, region, tiled=True)
    codes_d = marching.generate_codes(f, region, tiled=False)
    assert codes_t.num_tiles > 0 and codes_d.num_tiles == 0
    for a, b in zip(codes_t[:3], codes_d[:3]):
        assert torch.equal(a, b)
    mesh_t = _port_mesh("sparse", tiled=True)
    mesh_d = _port_mesh("sparse", tiled=False)
    for a, b in zip(mesh_t[:4], mesh_d[:4]):
        assert torch.equal(a, b)


# index mode -> a JAX vertex_cap in its band; levels -> vertex words
PACK_CASES = [(mode, levels) for mode in ("u16", "u21x3", "u32")
              for levels in (3, 7)]
VERTEX_CAPS = {"u16": 1 << 16, "u21x3": 1 << 20, "u32": 1 << 22}


@pytest.mark.parametrize("mode,levels", PACK_CASES)
def test_pack_readback_bitwise_equal_jax(mode, levels):
    """The port's image is the JAX image's live prefix, u16 for u16: every
    live half-word equal, and the same length. (A pad half-word after an
    odd count holds the JAX package's padding rows; nothing reads it.)"""
    import jax
    import jax.numpy as jnp
    from mlsgpu_tpu.ops import block as jblock
    field, region, origin = FIELDS["open"]
    jw, pw = _welded("open")
    jfmt = jblock.pack_format(levels, 3, VERTEX_CAPS[mode])
    fmt = block.PackFormat(*jfmt)
    assert fmt.index_mode == mode and fmt.vertex_words == (3 if levels == 3
                                                           else 4)
    jimg = np.asarray(jax.jit(jblock._pack_readback, static_argnums=(2, 3, 4))(
        jw, jnp.asarray(origin, jnp.int32), jfmt, VERTEX_CAPS[mode],
        CAPS["index_cap"]))
    img = block.pack_readback(pw, origin, fmt).numpy().view(np.uint32)
    ni, nv = pw.num_indices, pw.num_vertices
    assert len(img) == fmt.total_words(ni, nv)
    iw = fmt.index_words(ni)
    live = np.zeros(2 * len(img), bool)
    live[:2 * iw] = True
    if mode == "u16":
        live[ni:2 * iw] = False
    live[2 * iw:2 * iw + nv * fmt.vertex_words] = True
    np.testing.assert_array_equal(img.view(np.uint16)[live],
                                  jimg[:len(img)].view(np.uint16)[live])


@pytest.mark.parametrize("mode,levels", PACK_CASES)
def test_pack_readback_round_trip(mode, levels):
    """The native decoder and the numpy one read the image back: the same
    triangles and external keys as the welded mesh, and vertices within
    one t16 quantum (2^-16 of a cell)."""
    _, region, origin = FIELDS["open"]
    _, pw = _welded("open")
    fmt = block.PackFormat(mode, 3 if levels == 3 else 4, levels + 2)
    img = block.pack_readback(pw, origin, fmt).numpy().view(np.uint32)
    org = np.asarray(origin, np.int64)
    ni, nv, fe = pw.num_indices, pw.num_vertices, pw.first_external
    out = nat.unpack_readback(img, ni, nv, fe, mode, fmt.vertex_words, org)
    assert out is not None, "native library unavailable"
    verts, tris, keys = out
    np.testing.assert_array_equal(tris, pw.triangles.numpy())
    hi, lo = pw.key_hi.numpy()[fe:], pw.key_lo.numpy()[fe:]
    np.testing.assert_array_equal(keys, ((hi & 0x7FFFFFFF) << 32) | lo)
    np.testing.assert_allclose(verts, pw.vertices.numpy() + org, rtol=0,
                               atol=2e-5)
    v2, t2, k2 = block.unpack_readback(img, ni, nv, fe, fmt, org)
    np.testing.assert_array_equal(v2 + org.astype(np.float32), verts)
    np.testing.assert_array_equal(t2, tris)
    np.testing.assert_array_equal(k2, keys)


def test_pack_format_bands():
    """Index mode by the true welded count, in the JAX package's bands."""
    assert block.pack_format(3, 3, 1 << 16).index_mode == "u16"
    assert block.pack_format(3, 3, (1 << 16) + 1).index_mode == "u21x3"
    assert block.pack_format(6, 3, 1 << 21).index_mode == "u21x3"
    assert block.pack_format(6, 3, (1 << 21) + 1).index_mode == "u32"
    assert block.pack_format(6, 3, 10).vertex_words == 3      # 256 corners
    assert block.pack_format(7, 3, 10).vertex_words == 4      # 512 corners
    assert block.pack_format(12, 3, 10) is None               # > 2^13


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor whose equality is bitwise (floats as their int32 bits)."""
    t = t.cpu()
    return t.view(torch.int32) if t.is_floating_point() else t


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card's run with the "
                    "CPU's")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_tiled_and_dense_on_card_equal_cpu(cuda_device, name):
    field, region, _ = FIELDS[name]
    ref = marching.classify_dense(torch.as_tensor(field), region)
    for fn in (marching.classify_dense, marching.classify_tiled):
        got = fn(torch.as_tensor(field, device=cuda_device), region)
        for a, b in zip(ref[:3], got[:3]):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["closed", "open"])
def test_weld_and_pack_on_card_equal_cpu(cuda_device, name):
    field, region, origin = FIELDS[name]
    meshes = [_port_mesh(name, device) for device in ("cpu", cuda_device)]
    welded = [weld.weld(m.vertices, m.key_hi, m.key_lo, m.triangles)
              for m in meshes]
    for a, b in zip(meshes[0][:4], meshes[1][:4]):
        assert torch.equal(_bits(a), _bits(b))
    cpu, card = welded
    assert (cpu.num_vertices, cpu.first_external) == (card.num_vertices,
                                                      card.first_external)
    for a, b in zip(cpu[:4], card[:4]):
        assert torch.equal(_bits(a), _bits(b))
    for mode, levels in PACK_CASES:
        fmt = block.PackFormat(mode, 3 if levels == 3 else 4, levels + 2)
        assert torch.equal(block.pack_readback(cpu, origin, fmt),
                           block.pack_readback(card, origin, fmt).cpu())
