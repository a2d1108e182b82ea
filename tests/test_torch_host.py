"""The port's copy of the host layer against the JAX package's, on small
seeded clouds:
- the blob pass and the dense bucketing path give equal blobs, grids and
  buckets;
- `OOCMesher` writes the same PLY bytes from the same block inputs;
- `build_parser` and `config_from_args` give equal options and configs for
  the same argv;
- the port's native `unpack_readback` equals the JAX package's numpy
  decoder bit for bit, and its native `rebuild_block` of a codes image gives
  the mesh the JAX package emits and welds on the device (`generate(emit=
  "mesh")` and `weld.weld`): the same triangles, external keys and first
  external vertex, positions within one t16 quantum.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlsgpu_tpu import cli as jcli
from mlsgpu_tpu.core import chunk as jchunk
from mlsgpu_tpu.io import splat_set as jsplat_set
from mlsgpu_tpu.ops import block as jblock
from mlsgpu_tpu.ops import marching as jmarch
from mlsgpu_tpu.ops import weld as jweld
from mlsgpu_tpu.pipeline import blobs as jblobs
from mlsgpu_tpu.pipeline import bucket as jbucket
from mlsgpu_tpu.pipeline import mesher as jmesher
from mlsgpu_tpu_torch import _native as nat
from mlsgpu_tpu_torch import cli
from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.core import chunk
from mlsgpu_tpu_torch.io.splat_set import SequenceSource
from mlsgpu_tpu_torch.ops import block, marching, weld
from mlsgpu_tpu_torch.pipeline import blobs, bucket, mesher
from mlsgpu_tpu_torch.pipeline import reconstruct as trec

from tests import oracle

CAPS = dict(cell_cap=1 << 14, vertex_cap=1 << 16, index_cap=3 << 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def two_spheres(seed, n=4000, nan_rows=0):
    """A large and a small sphere; `nan_rows` splats made non-finite."""
    rng = np.random.default_rng(seed)
    out = np.concatenate([
        oracle.sphere_cloud(np.array([0.7, -0.3, 0.2]), 2.5, n, 0.3, rng),
        oracle.sphere_cloud(np.array([4.5, 1.0, -0.5]), 0.8, n // 8, 0.3,
                            rng)])
    out[rng.choice(len(out), nan_rows, replace=False), 0] = np.nan
    return out


# ------------------------------------------------- blobs and dense buckets
BLOB_CASES = {
    "default": dict(seed=1, spacing=0.1, micro=8, block=31, max_splats=4000,
                    chunk=None, mem=None),
    "chunks_nonfinite": dict(seed=2, spacing=0.1, micro=8, block=31,
                             max_splats=900, chunk=16, mem=None, nan=7),
    "spilled_blobs": dict(seed=3, spacing=0.07, micro=16, block=63,
                          max_splats=2500, chunk=None, mem=4096),
}


@pytest.mark.parametrize("case", sorted(BLOB_CASES))
def test_blobs_and_dense_buckets_equal_jax(case):
    c = BLOB_CASES[case]
    splats = two_spheres(c["seed"], nan_rows=c.get("nan", 0))
    info = blobs.compute_blobs(SequenceSource(splats), c["spacing"],
                               c["micro"], mem_budget=c["mem"])
    jinfo = jblobs.compute_blobs(jsplat_set.SequenceSource(splats),
                                 c["spacing"], c["micro"],
                                 mem_budget=c["mem"])
    assert dataclasses.astuple(info.grid) == dataclasses.astuple(jinfo.grid)
    assert (info.num_splats, info.num_nonfinite) == (jinfo.num_splats,
                                                     jinfo.num_nonfinite)
    assert info.num_nonfinite == c.get("nan", 0)
    for name in ("micro_lo", "micro_dims"):
        np.testing.assert_array_equal(getattr(info, name),
                                      getattr(jinfo, name))
    for name in ("start", "count", "lo", "hi"):
        np.testing.assert_array_equal(getattr(info.blobs, name),
                                      getattr(jinfo.blobs, name))
    assert (info.micro_dims <= bucket.MAX_MICRO_GRID).all()   # dense path
    kw = dict(max_splats=c["max_splats"], chunk_cells=c["chunk"])
    got = bucket.make_buckets(info, c["block"], c["micro"], **kw)
    ref = jbucket.make_buckets(jinfo, c["block"], c["micro"], **kw)
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        assert (a.chunk_id.gen, a.chunk_id.coords) == (b.chunk_id.gen,
                                                       b.chunk_id.coords)
        assert a.num_splats == b.num_splats
        for name in ("cell_lo", "cell_hi", "blob_ids", "skeleton"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


# ------------------------------------------------------------------ mesher
@pytest.fixture(scope="module")
def mesher_inputs(tmp_path_factory):
    """The port's block inputs of a two-sphere run on the CPU (recorded by
    a mesher that keeps what it is given), with the JAX package's grid."""
    splats = two_spheres(5, n=5000)
    cfg = ReconstructConfig(fit_grid=0.1, fit_smooth=1.0, levels=3,
                            subsampling=3, leaf_cells=8, progress=False)
    info = blobs.compute_blobs(SequenceSource(splats), cfg.fit_grid,
                               cfg.micro_cells)
    jgrid = jblobs.compute_blobs(jsplat_set.SequenceSource(splats),
                                 cfg.fit_grid, cfg.micro_cells).grid

    class Recorder(mesher.OOCMesher):
        """Keeps a copy of each block a run prepares (a decoded block
        hands its triangles over to the records), in the order of its
        commits (the loader's order; prepares run on a pool)."""

        def __init__(self, grid):
            super().__init__(grid)
            self.blocks = []
            self._given = {}

        def prepare(self, b):
            kept = dataclasses.replace(b, triangles=b.triangles.copy())
            prepared = super().prepare(b)
            self._given[id(prepared)] = kept
            return prepared

        def commit(self, prepared):
            self.blocks.append(self._given.pop(id(prepared)))
            super().commit(prepared)

    rec = Recorder(info.grid)
    out = str(tmp_path_factory.mktemp("mesher") / "run.ply")
    trec.reconstruct(SequenceSource(splats), cfg, out, device="cpu",
                     mesher=rec)
    assert len(rec.blocks) > 4
    return info.grid, jgrid, rec.blocks


@pytest.mark.parametrize("prune", [0.0, 0.3])
@pytest.mark.parametrize("budget", [2 << 30, 4096])
def test_mesher_bytes_equal_jax(mesher_inputs, tmp_path, prune, budget):
    """Both meshers, fed the same blocks in the same order, write the same
    bytes; prune 0.3 drops the small sphere, a 4 KiB reorder budget makes
    both spill to disk."""
    grid, jgrid, blocks = mesher_inputs
    outs = []
    for name, mod, chunk_mod, g in (("port", mesher, chunk, grid),
                                    ("jax", jmesher, jchunk, jgrid)):
        m = mod.OOCMesher(g, prune=prune, reorder_budget=budget)
        for b in blocks:
            cid = chunk_mod.ChunkId(gen=b.chunk_id.gen,
                                    coords=b.chunk_id.coords)
            m.add(mod.BlockInput(chunk_id=cid, vertices=b.vertices,
                                 first_external=b.first_external,
                                 ext_keys=b.ext_keys, triangles=b.triangles))
        path = str(tmp_path / f"{name}.ply")
        assert m.write(path) == [path]
        m.cleanup()
        with open(path, "rb") as f:
            outs.append(f.read())
    assert len(outs[0]) > 10000
    assert outs[0] == outs[1]


# --------------------------------------------------------------------- CLI
ARGVS = {
    "defaults": ["-o", "out.ply", "in.ply"],
    "fit": ["--fit-grid", "0.05", "--fit-smooth", "2", "--fit-prune", "0.1",
            "--fit-boundary-limit", "0.5", "--fit-shape", "plane",
            "--max-radius", "3", "-o", "o.ply", "a.ply", "b.ply"],
    "octree": ["--levels", "5", "--subsampling", "2", "--leaf-cells", "16",
               "--device-block-shift", "8", "--tile-candidates", "1K",
               "--max-device-splats", "2M", "--device-threads", "4",
               "-o", "o.ply", "i.ply"],
    "memory": ["--mem-reorder", "1G", "--mem-load-splats", "64M",
               "--mem-host-splats", "3G", "--mem-bucket-splats", "512M",
               "--mem-mesh", "256M", "--mem-blobs", "10M", "--max-split",
               "100", "--split-size", "1G", "-o", "o.ply", "i.ply"],
    "io": ["--checkpoint", "c.state", "--tmp-dir", "tmp", "--reader", "mmap",
           "--writer", "stream", "--decache", "--scatter", "static",
           "--readback", "packed", "--mls-backend", "auto", "-o", "o.ply",
           "i.ply"],
    "observability": ["--resume", "c.state", "--statistics",
                      "--statistics-file", "s.txt", "--statistics-device",
                      "--timeplot", "t.txt", "--profile", "prof", "--quiet",
                      "--no-progress", "--num-devices", "1", "-o", "o.ply"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_cli_config_equal_jax(name):
    argv = ARGVS[name]
    args = cli.build_parser().parse_args(argv)
    jargs = jcli.build_parser().parse_args(argv)
    ours = vars(args)
    assert ours.pop("device") == "cuda"
    assert ours == vars(jargs)
    assert (dataclasses.asdict(cli.config_from_args(args))
            == dataclasses.asdict(jcli.config_from_args(jargs)))


# ------------------------------------------------------------------ native
def sphere_field(b, center, radius):
    g = np.arange(b, dtype=np.float64)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt((xx - center[0]) ** 2 + (yy - center[1]) ** 2
                    + (zz - center[2]) ** 2) - radius).astype(np.float32)


def _fields():
    closed = sphere_field(32, (15.5, 15.3, 15.8), 9.0)
    open_ = sphere_field(40, (30.0, 12.0, 20.0), 14.0)
    open_[np.random.default_rng(4).random(open_.shape) < 0.01] = np.nan
    holed = sphere_field(24, (11.5, 11.5, 11.5), 8.0)
    holed[:, :, :5] = np.nan
    return {"closed": (closed, (31, 31, 31), (0, 0, 0)),
            "open": (open_, (35, 39, 30), (64, 32, 8)),
            "holed": (holed, (23, 23, 23), (3, 5, 7)),
            "cut_region": (closed, (31, 20, 13), (3, 5, 7))}


FIELDS = _fields()


@pytest.fixture(scope="module")
def welded_open():
    field, region, origin = FIELDS["open"]
    m = marching.generate_mesh(torch.as_tensor(field), region, origin)
    return weld.weld(m.vertices, m.key_hi, m.key_lo, m.triangles), origin


@pytest.mark.parametrize("mode", ["u16", "u21x3", "u32"])
@pytest.mark.parametrize("vertex_words", [3, 4])
def test_native_unpack_equals_jax_numpy(welded_open, mode, vertex_words):
    w, origin = welded_open
    fmt = block.PackFormat(mode, vertex_words, 6 if vertex_words == 3 else 9)
    img = block.pack_readback(w, origin, fmt).numpy().view(np.uint32)
    org = np.asarray(origin, np.int64)
    ni, nv, fe = w.num_indices, w.num_vertices, w.first_external
    assert 0 < fe < nv
    assert nat.available(), nat.last_error
    v, t, k = nat.unpack_readback(img, ni, nv, fe, mode, vertex_words, org)
    jv, jt, jk = jblock.unpack_readback(img, ni, nv, fe,
                                        jblock.PackFormat(*fmt), org)
    jv = jv + org.astype(np.float32)
    np.testing.assert_array_equal(v.view(np.uint32), jv.view(np.uint32))
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(k, jk)


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_native_rebuild_equals_jax_mesh(name):
    field, region, origin = FIELDS[name]
    cm = jmarch.generate(jnp.asarray(field), jnp.asarray(region, jnp.int32),
                         jnp.asarray(origin, jnp.int32), **CAPS, emit="codes")
    jimg = np.asarray(jax.jit(jblock._pack_codes, static_argnums=(1, 2))(
        cm, CAPS["cell_cap"], CAPS["vertex_cap"]))
    assert nat.available(), nat.last_error
    v, t, k, fe = nat.rebuild_block(
        jimg, int(cm.num_cells), int(cm.num_vertices), int(cm.num_indices),
        field.shape[0] - 1, np.asarray(origin, np.int64),
        np.asarray(region, np.int64))

    m = jax.jit(functools.partial(jmarch.generate, **CAPS))(
        jnp.asarray(field), jnp.asarray(region, jnp.int32),
        jnp.asarray(origin, jnp.int32))
    jw = jweld.weld(m.vertices, m.key_hi, m.key_lo, m.triangles,
                    m.num_vertices, m.num_indices)
    nw, rfe, ni = (int(jw.num_vertices), int(jw.first_external),
                   int(jw.num_indices))
    rv = np.asarray(jw.vertices)[:nw] + np.asarray(origin, np.float32)
    rt = np.asarray(jw.triangles)[:ni // 3]
    hi = np.asarray(jw.key_hi)[rfe:nw].astype(np.int64)
    lo = np.asarray(jw.key_lo)[rfe:nw].astype(np.int64)
    assert (len(v), len(t), fe) == (nw, ni // 3, rfe) and nw > 300
    # The host rebuild numbers vertices in its own order (externals too,
    # where the region cuts the field): match them through the triangles.
    perm = np.full(len(v), -1)
    perm[t.ravel()] = rt.ravel()
    np.testing.assert_array_equal(perm[t.ravel()], rt.ravel())
    assert len(np.unique(perm)) == len(v) and (perm >= 0).all()
    assert (perm[:fe] < fe).all() and (perm[fe:] >= fe).all()
    np.testing.assert_array_equal(k, (((hi & 0x7FFFFFFF) << 32) | lo)[
        perm[fe:] - fe])
    np.testing.assert_allclose(v, rv[perm], rtol=0, atol=2e-5)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_read_ranges_equal_jax(tmp_path, monkeypatch, native):
    """The port's FileSource, which decodes each run of ranges in one file
    with one call straight into the caller's buffer (read_ranges_into: the
    streamer's shared-memory read), gives the JAX package's FileSource's
    bytes: ranges that cross file ends, out of order, empty, one splat."""
    from mlsgpu_tpu.io import ply as jply
    from mlsgpu_tpu_torch.io.splat_set import FileSource
    rng = np.random.default_rng(11)
    paths = []
    for i, n in enumerate((700, 5, 1300)):
        s = rng.normal(size=(n, 8)).astype(np.float32)
        s[:, 3] = rng.uniform(0.05, 0.5, n)
        p = str(tmp_path / f"part{i}.ply")
        jply.write_splats_ply(p, s)
        paths.append(p)
    if not native:
        monkeypatch.setattr(nat, "decode_splats", lambda *a, **kw: None)
    ranges = [(650, 1500), (0, 3), (704, 706), (10, 10), (1999, 2005),
              (100, 101)]
    port = FileSource(paths, smooth=1.5, max_radius=0.4)
    ref = jsplat_set.FileSource(paths, smooth=1.5, max_radius=0.4)
    want = ref.read_ranges(ranges)
    assert port.read_ranges(ranges).tobytes() == want.tobytes()
    out = torch.empty(want.shape, dtype=torch.float32).share_memory_()
    port.read_ranges_into(ranges, out.numpy())
    assert out.numpy().tobytes() == want.tobytes()
    seq = SequenceSource(want)
    again = np.empty_like(want)
    seq.read_ranges_into([(0, 900), (900, len(want))], again)
    assert again.tobytes() == want.tobytes()
    assert port.read_ranges([]).shape == (0, 8)
