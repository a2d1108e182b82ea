"""The mesher's two halves (pipeline/mesher.py: OOCMesher.prepare, which
reads a block alone, and OOCMesher.commit, in the blocks' order) through
streamer.consume_threaded's prepare pool against one-thread `add`: after
every block the spill records, the clump arrays and the key maps are
bitwise equal, on the native path and the numpy fallback, with pools of 1,
2 and 4 threads and with prepares made to finish in reverse order; a
corrupt triangle index raised on a pool thread ends the run; a host filter
chain runs before each prepare, in the loader's order; a short
`reconstruct` records the pool's statistics and spans, and the benchmark's
reader reads them.
"""

import dataclasses
import gc
import os
import threading
import time
import weakref

import numpy as np
import pytest

from mlsgpu_tpu_torch import _native
from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.core.chunk import ChunkId
from mlsgpu_tpu_torch.core.grid import Grid
from mlsgpu_tpu_torch.io import ply
from mlsgpu_tpu_torch.io.splat_set import SequenceSource
from mlsgpu_tpu_torch.pipeline import reconstruct as trec
from mlsgpu_tpu_torch.pipeline import streamer
from mlsgpu_tpu_torch.pipeline.mesher import BlockInput, OOCMesher
from mlsgpu_tpu_torch.utils import misc, timeplot
from mlsgpu_tpu_torch.utils.errors import StateError
from mlsgpu_tpu_torch.utils.statistics import get_registry

from tests import oracle

GRID = Grid.make((0, 0, 0), 0.25, [(0, 64)] * 3)


def _component_tris(idx, rng):
    """A connected strip over the vertex ids `idx`, in a random order."""
    idx = rng.permutation(idx)
    return np.stack([idx[:-2], idx[1:-1], idx[2:]], axis=1)


def make_block(rng, coords, n_int, n_ext, keys, small=0):
    """A block of n_int internal and n_ext external vertices (keys drawn
    from `keys` with replacement: the same key in another block, or twice
    in this one), one large component and `small` one-triangle components
    (which --fit-prune drops), vertex ids of all components interleaved."""
    n = n_int + n_ext
    verts = rng.random((n, 3)).astype(np.float32) * 60
    order = rng.permutation(n)
    tris = [_component_tris(order[3 * small:], rng)] if n > 3 * small + 2 \
        else []
    tris += [order[3 * i:3 * i + 3][None] for i in range(small)]
    tris = (np.concatenate(tris) if tris else np.zeros((0, 3))).astype(
        np.int32)
    ext = rng.choice(keys, n_ext).astype(np.int64)
    return BlockInput(ChunkId(coords=coords), verts, n_int, ext, tris)


def blocks(seed=7):
    """Two output chunks; externals shared between blocks of a chunk and
    across chunks; in-block duplicate keys; small components; an empty
    block; a block of externals only."""
    rng = np.random.default_rng(seed)
    keys = np.arange(1 << 40, (1 << 40) + 48, dtype=np.int64)
    a, b = (0, 0, 0), (1, 0, 0)
    return [make_block(rng, a, 300, 40, keys, small=3),
            make_block(rng, a, 200, 60, keys, small=1),
            BlockInput(ChunkId(coords=a), np.zeros((0, 3), np.float32), 0,
                       np.zeros(0, np.int64), np.zeros((0, 3), np.int32)),
            make_block(rng, b, 150, 30, keys, small=2),
            make_block(rng, b, 0, 12, keys),
            make_block(rng, a, 120, 50, keys, small=4),
            make_block(rng, b, 90, 25, keys[:8], small=1),
            make_block(rng, a, 60, 16, keys[40:])]


def _items(keymap):
    k, v = keymap.items_arrays()
    order = np.argsort(k)
    return k[order].tolist(), v[order].tolist()


def snapshot(m):
    """Everything a commit leaves: the clump arrays, the global key map and
    per chunk its counts, clump ranges, key map and spill records."""
    cl = m.clumps
    out = [a.tobytes() for a in (cl.parent, cl.size, cl.num_vertices,
                                 cl.num_triangles)]
    out.append(_items(m.key_clump))
    for coords in sorted(m.chunks):
        rec = m.chunks[coords]
        raw = [bytes(store.read(off, count * size))
               for segs, store, size in ((rec.vert_segments, m._verts, 16),
                                         (rec.tri_segments, m._tris, 12))
               for off, count in segs]
        out.append((coords, rec.num_vertices, rec.num_triangles,
                    list(rec.clump_ranges), _items(rec.key_index), raw))
    return out


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """The native library's path, or the numpy fallback (no library)."""
    if request.param == "native":
        if not _native.available():
            pytest.skip("native library unavailable: "
                        f"{_native.last_error}")
    else:
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    return request.param


@pytest.mark.parametrize("order", ["in_order", "reversed"])
@pytest.mark.parametrize("threads", [1, 2, 4])
def test_pool_commits_equal_one_thread_add(path, threads, order):
    """After every block, the pool's commits leave the state one-thread
    `add` leaves, bit for bit, whichever prepare finishes first, with the
    triangles handed over (written in place as the records)."""
    seq = blocks()
    one = OOCMesher(GRID, prune=0.3)
    want = []
    for b in seq:
        one.add(b)
        want.append(snapshot(one))
    assert len(one.chunks) == 2 and len(one.clumps) > 10

    pooled = OOCMesher(GRID, prune=0.3)
    got, done = [], []

    def prepare(i, block):
        if order == "reversed":   # later blocks finish first
            time.sleep(0.03 * (len(seq) - i))
        # as a run hands a decoded block over: the triangles become the
        # records
        out = pooled.prepare(dataclasses.replace(
            block, triangles=block.triangles.copy(), owns_triangles=True))
        done.append(i)
        return out

    def commit(i, prepared):
        pooled.commit(prepared)
        got.append(snapshot(pooled))

    streamer.consume_threaded(enumerate(seq), commit, depth=threads,
                              prepare=prepare, threads=threads)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"state after block {i} differs"
    if order == "reversed" and threads > 1:
        assert done != sorted(done)
    for m in (one, pooled):
        m.cleanup()


def test_pruned_output_bytes_equal(path, tmp_path):
    """The pooled mesher's PLY, with the small components pruned, is the
    one-thread mesher's byte for byte."""
    out = []
    for threads in (0, 3):
        m = OOCMesher(GRID, prune=0.3)
        if threads:
            streamer.consume_threaded(
                ((None, b) for b in blocks(11)),
                lambda _, p: m.commit(p), prepare=lambda _, b: m.prepare(b),
                threads=threads)
        else:
            for b in blocks(11):
                m.add(b)
        p = str(tmp_path / f"t{threads}.ply")
        m.write(p)
        m.cleanup()
        with open(p, "rb") as f:
            out.append(f.read())
    v, t = ply.read_mesh(str(tmp_path / "t3.ply"))
    assert 0 < len(t) < sum(len(b.triangles) for b in blocks(11))
    assert out[0] == out[1]


def test_corrupt_block_raises_from_a_pool_thread(path):
    """A triangle index past the block's vertices raises StateError in its
    prepare, on a pool thread; the run ends with it and no later block is
    committed."""
    seq = blocks()
    bad = seq[3]
    tris = bad.triangles.copy()
    tris[5, 1] = len(bad.vertices)
    seq[3] = BlockInput(bad.chunk_id, bad.vertices, bad.first_external,
                        bad.ext_keys, tris)
    m = OOCMesher(GRID)
    committed, where = [], []

    def prepare(i, block):
        where.append(threading.current_thread().name)
        return m.prepare(block)

    with pytest.raises(StateError, match="corrupt block mesh"):
        streamer.consume_threaded(enumerate(seq),
                                  lambda i, p: (m.commit(p),
                                                committed.append(i)),
                                  prepare=prepare, threads=2)
    assert committed == [0, 1, 2]
    assert all(w.startswith("mesher_prep") for w in where)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("mesher")]
    m.cleanup()


def test_pool_width_follows_the_cores(monkeypatch):
    """Half the cores, at least one, at most the depth + 1 items the pool
    may hold: two or more threads wherever four cores are there."""
    for cores, depth, want in ((1, 2, 1), (3, 2, 1), (4, 2, 2), (8, 2, 3),
                               (64, 2, 3), (64, 5, 6)):
        monkeypatch.setattr(misc, "cores", lambda c=cores: c)
        assert streamer.prepare_threads(depth) == want


# ----------------------------------------------------- through reconstruct
def _config():
    return ReconstructConfig(fit_grid=0.1, fit_smooth=1.0, levels=3,
                             subsampling=3, leaf_cells=8, progress=False)


def _splats():
    return oracle.sphere_cloud(np.array([0.7, -0.3, 0.2]), 1.0, 1500, 0.3,
                               np.random.default_rng(5))


def _key(vertices):
    return len(vertices), vertices[:2].tobytes()


def test_filter_chain_runs_before_each_prepare_in_order(tmp_path,
                                                        monkeypatch):
    """With a host filter chain the pool is one thread: the filter sees
    each block before its prepare, on that thread, in the order the stream
    yields the blocks (the loader's), and the PLY is the unfiltered run's
    byte for byte when the filter changes nothing."""
    events = []
    stream, prepare = trec.stream_blocks, OOCMesher.prepare

    def recorded_stream(*args, **kw):
        blocks = stream(*args, **kw)
        try:
            for bucket, block in blocks:
                events.append(("yield", _key(block.vertices)))
                yield bucket, block
        finally:
            blocks.close()

    def traced_prepare(self, block, **kw):
        events.append(("prepare", _key(block.vertices), id(block.vertices)))
        return prepare(self, block, **kw)

    class Ident:
        def __call__(self, vertices, triangles):
            events.append(("filter", _key(vertices), id(vertices),
                           threading.current_thread().name))
            return vertices, triangles

    monkeypatch.setattr(trec, "stream_blocks", recorded_stream)
    monkeypatch.setattr(OOCMesher, "prepare", traced_prepare)
    out = []
    for name, filters in (("plain", None), ("filtered", Ident())):
        events.clear()
        get_registry().clear()
        path = str(tmp_path / f"{name}.ply")
        trec.reconstruct(SequenceSource(_splats()), _config(), path,
                         device="cpu", filters=filters)
        with open(path, "rb") as f:
            out.append(f.read())
    assert out[0] == out[1]
    assert get_registry().to_dict()["mesher.prepareThreads"]["total"] == 1
    yielded = [e[1] for e in events if e[0] == "yield"]
    filtered = [e for e in events if e[0] == "filter"]
    prepared = [e for e in events if e[0] == "prepare"]
    assert len(yielded) == len(filtered) == len(prepared) > 2
    assert [f[1] for f in filtered] == yielded
    for f, p in zip(filtered, prepared):
        assert f[3].startswith("mesher_prep")
        assert f[2] == p[2]     # the filter's output is what is prepared
        assert events.index(f) < events.index(p)


def test_pool_statistics_and_spans(tmp_path):
    """Over a short reconstruct: mesher.prepareTime, prepareCpu and
    prepareWait have a sample a block, prepareThreads is the pool's width,
    the `prepare` actions lie on the `mesher_prep` workers, one a block,
    and the `mesher` actions (the commits) keep mesher.time and
    mesher.cpu."""
    trace = str(tmp_path / "trace.txt")
    get_registry().clear()
    timeplot.init(trace)
    try:
        trec.reconstruct(SequenceSource(_splats()), _config(),
                         str(tmp_path / "out.ply"), device="cpu")
    finally:
        timeplot.init(None)
    stats = get_registry().to_dict()
    blocks = stats["bucket.count"]["total"]
    assert blocks > 2
    for name in ("mesher.prepareTime", "mesher.prepareCpu",
                 "mesher.prepareWait", "mesher.time", "mesher.cpu"):
        assert stats[name]["n"] == blocks, name
    width = streamer.prepare_threads(2)
    assert stats["mesher.prepareThreads"]["total"] == width
    with open(trace) as f:
        events = [ln.split() for ln in f if ln.startswith("EVENT ")]
    prep = [e for e in events if e[2] == "prepare"]
    assert len(prep) == blocks
    assert {e[1] for e in prep} <= {f"mesher_prep.{i}"
                                    for i in range(width)}
    assert all(e[1] == "mesher" for e in events if e[2] == "mesher")
    tick = 1.0 / os.sysconf("SC_CLK_TCK")
    assert (stats["mesher.prepareCpu"]["sum"]
            <= stats["mesher.prepareTime"]["sum"] + blocks * tick)


def test_the_pool_keeps_nothing_alive():
    """Nothing a run hands the pool outlives consume_threaded without a
    garbage collection: a reference cycle through the pool would keep each
    job's mesher, and every record it holds, until the next collection."""
    class Prepare:
        def __call__(self, i, x):
            return x

    prepare = Prepare()
    ref = weakref.ref(prepare)
    gc.disable()
    try:
        streamer.consume_threaded(((i, i) for i in range(5)),
                                  lambda i, x: None, prepare=prepare)
        del prepare
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_records_alias_only_owned_triangles(path, dtype):
    """A block's records are memory of their own, on both paths, unless
    the block owns its int32 triangles (the decode made them): then the
    native path writes the triangle records into them. The caller's arrays
    are otherwise left as they were, and an int32 copy made of wider
    triangles may become the records. Either way the spill is the same."""
    base = blocks()[0]
    block = dataclasses.replace(base, triangles=base.triangles.astype(dtype))
    kept = block.triangles.copy(), block.vertices.copy()
    spills = []
    for owns in (False, True):
        m = OOCMesher(GRID)
        b = dataclasses.replace(block, triangles=block.triangles.copy(),
                                owns_triangles=owns)
        p = m.prepare(b if owns else block)
        handed = owns and dtype is np.int32 and path == "native"
        assert np.shares_memory(p.records.trec, b.triangles) == handed
        for r in (p.records.trec, p.records.vrec):
            assert not np.shares_memory(r, block.triangles)
            assert not np.shares_memory(r, block.vertices)
        m.commit(p)
        spills.append(snapshot(m))
        m.cleanup()
    np.testing.assert_array_equal(block.triangles, kept[0])
    np.testing.assert_array_equal(block.vertices, kept[1])
    assert spills[0] == spills[1]


@pytest.mark.parametrize("readback", ["raw", "packed", "codes"])
def test_records_never_alias_the_readback(monkeypatch, tmp_path, readback):
    """The raw readback's block arrays are views of the readback's host
    tensors, which the block does not own; the records the mesher spills
    share no memory with any readback, so a readback buffer is freed or
    reused once its block is decoded. The packed and codes decodes make
    the triangles, which the block owns and the records take over."""
    host, seen = [], []
    host_arrays, prepare = streamer._host_arrays, OOCMesher.prepare

    def spy_host_arrays(mode, hosts):
        out = host_arrays(mode, hosts)
        host.extend(out)
        return out

    def spy_prepare(self, block):
        out = prepare(self, block)
        seen.append((block, out.records))
        return out

    monkeypatch.setattr(streamer, "_host_arrays", spy_host_arrays)
    monkeypatch.setattr(OOCMesher, "prepare", spy_prepare)
    trec.reconstruct(SequenceSource(_splats()),
                     dataclasses.replace(_config(), readback=readback),
                     str(tmp_path / "out.ply"), device="cpu")
    assert len(host) == (4 if readback == "raw" else 1) * len(seen)
    assert len(seen) > 2
    for block, r in seen:
        assert block.owns_triangles == (readback != "raw")
        if r is None:
            continue
        for a in host:
            assert not np.shares_memory(r.vrec, a)
            assert not np.shares_memory(r.trec, a)
        if _native.available() and len(r.trec):
            assert (np.shares_memory(r.trec, block.triangles)
                    == block.owns_triangles)
