"""Several devices and several queues per device in the port's streamer
(the port's counterpart of tests/test_pipeline.py::
test_spare_capacity_device_scheduling, plus what only the port has: worker
processes, the ordered yield, one --mem-mesh budget over all workers, a
failing worker). tests/test_torch_workers.py holds the worker processes
themselves.

The CPU stands in for the cards: a device list may name one device more
than once and each entry gets its own workers, as the JAX tests get their
virtual devices. Everything compared here is an integer or a byte string
and must be equal bit for bit; no tolerance is used."""

import multiprocessing
import threading
import time

import numpy as np
import pytest
import torch

from mlsgpu_tpu_torch import cli
from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.device import resolve_devices
from mlsgpu_tpu_torch.io import ply
from mlsgpu_tpu_torch.io.splat_set import SequenceSource
from mlsgpu_tpu_torch.ops import launches
from mlsgpu_tpu_torch.ops.block import block_step
from mlsgpu_tpu_torch.pipeline import blobs as blobs_mod
from mlsgpu_tpu_torch.pipeline import bucket as bucket_mod
from mlsgpu_tpu_torch.pipeline import reconstruct as trec
from mlsgpu_tpu_torch.pipeline import resources
from mlsgpu_tpu_torch.pipeline import streamer as streamer_mod
from mlsgpu_tpu_torch.utils import misc
from mlsgpu_tpu_torch.utils.errors import InvalidOption
from mlsgpu_tpu_torch.utils.manifold import check_manifold
from mlsgpu_tpu_torch.utils.statistics import Peak, get_registry

from tests import oracle

CPU = torch.device("cpu")
#: Seconds a streamer call may take before a test calls it hung.
HANG_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cloud(n=5000, seed=0, center=(5, 5, 5), radius=3.0, sr=0.1):
    """tests/test_pipeline.py's cloud."""
    return oracle.sphere_cloud(center, radius, n, sr,
                               np.random.default_rng(seed))


#: tests/test_pipeline.py::test_spare_capacity_device_scheduling's options.
OPTIONS = dict(fit_grid=0.1, fit_smooth=1.0, levels=4, subsampling=3,
               leaf_cells=8, max_device_splats=3000, tile_candidates=512,
               progress=False)


#: Splat radius of the cloud most tests use. That test's own cloud (radius
#: 0.1, one cell) is too sparse for a surface: its blocks come out empty.
SR = 0.3


def _setup(sr=SR, **kw):
    cfg = ReconstructConfig(**{**OPTIONS, **kw})
    source = SequenceSource(make_cloud(n=8000, seed=7, sr=sr))
    info = blobs_mod.compute_blobs(source, cfg.fit_grid, cfg.micro_cells)
    buckets = bucket_mod.make_buckets(info, cfg.device_block_cells,
                                      cfg.micro_cells,
                                      max_splats=cfg.max_device_splats)
    assert len(buckets) >= 8, "test needs several buckets"
    return cfg, source, info, buckets


def _bounded(fn, seconds=HANG_S):
    """fn() on a thread; fails the test if it has not returned in time.
    Returns (result, exception)."""
    box = {}

    def run():
        try:
            box["result"] = fn()
        except BaseException as e:
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"still running after {seconds} s (deadlock?)"
    return box.get("result"), box.get("error")


def _stream(cfg, source, info, buckets, devices, **kw):
    """The run's blocks; no process it started is left, however it ends."""
    _, readback = trec.prepare_run(cfg, "cpu")
    get_registry().clear()
    before = misc.child_pids()
    out, err = _bounded(lambda: list(streamer_mod.stream_blocks(
        source, info, buckets, cfg, devices, readback, **kw)))
    assert misc.child_pids() <= before
    if err is not None:
        raise err
    return out


def _worker_blocks():
    stats = get_registry().to_dict()
    return {k[len("device.blocks."):]: v["total"] for k, v in stats.items()
            if k.startswith("device.blocks.")}


def _no_streamer_threads():
    """No loader, worker or decode thread, and no worker process, is
    left."""
    names = [t.name for t in threading.enumerate()
             if t.name == "loader" or t.name.startswith(("device.",
                                                         "decode."))]
    assert not names, names
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("sr", [0.1, SR])
def test_four_devices_yield_in_order_bitwise_one_device(sr):
    """Over devices=[cpu]*4 every bucket comes out once, in the loader's
    order, every worker ran a block, and each HostBlock is bitwise the
    one-device run's: on that test's cloud (sr 0.1) and on one with a
    surface."""
    cfg, source, info, buckets = _setup(sr=sr)
    one = _stream(cfg, source, info, buckets, CPU)
    assert _worker_blocks() == {"0.0": len(buckets)}
    four = _stream(cfg, source, info, buckets, [CPU] * 4)
    blocks = _worker_blocks()
    assert sorted(blocks) == ["0.0", "1.0", "2.0", "3.0"]
    assert all(v > 0 for v in blocks.values()), blocks
    assert sum(blocks.values()) == len(buckets)
    assert [b for b, _ in four] == list(buckets) == [b for b, _ in one]
    for (_, r1), (_, r4) in zip(one, four):
        assert r1.readback == r4.readback and r1.fmt == r4.fmt
        np.testing.assert_array_equal(r1.counts, r4.counts)
        assert len(r1.arrays) == len(r4.arrays) >= 1
        for a1, a4 in zip(r1.arrays, r4.arrays):
            assert a1.dtype == a4.dtype and a1.tobytes() == a4.tobytes()
    if sr == SR:
        assert sum(r.num_cells > 0 for _, r in four) >= 8
    _no_streamer_threads()


def test_queues_and_devices_multiply():
    """--device-threads T on D device entries makes D x T workers."""
    cfg, source, info, buckets = _setup(device_threads=2)
    got = _stream(cfg, source, info, buckets, [CPU] * 2)
    assert [b for b, _ in got] == list(buckets)
    blocks = _worker_blocks()
    assert sorted(blocks) == ["0.0", "0.1", "1.0", "1.1"]
    assert sum(blocks.values()) == len(buckets)
    stats = get_registry().to_dict()
    assert stats["device.time"]["n"] == len(buckets)
    per_worker = sum(v["sum"] for k, v in stats.items()
                     if k.startswith("device.workerTime."))
    assert per_worker >= stats["device.time"]["sum"] > 0


def _counts_agree_with_the_jax_packages(monkeypatch, cache_dir):
    """The same buckets through the JAX package's stream_blocks over four
    of its virtual devices give the same per-block integer counts
    (vertices, indices, cells). The two packages' fields agree to float
    noise, which can flip a handful of near-zero corners (the bar of
    tests/test_torch_block.py), so: most blocks are equal bit for bit,
    every block is within max(n // 100, 48) of the JAX package's count,
    and the sums over the run within n // 500.

    Both sides run readback "codes", named: with "auto" each package
    resolves the mode from its own native library, and a codes block
    counts one vertex per emission where a packed one counts welded
    vertices. The JAX caps cache is a fresh directory, so caps grown by
    other tests in this process do not move the JAX package's fields."""
    import jax
    from mlsgpu_tpu.config import ReconstructConfig as JConfig
    from mlsgpu_tpu.io.splat_set import SequenceSource as JSource
    from mlsgpu_tpu.pipeline import blobs as jblobs
    from mlsgpu_tpu.pipeline import bucket as jbucket
    from mlsgpu_tpu.pipeline import streamer as jstreamer
    from mlsgpu_tpu.pipeline.reconstruct import load_cached_caps

    devices = jax.local_devices()
    if len(devices) < 4:
        pytest.skip("needs >= 4 virtual devices")
    monkeypatch.setenv("MLSGPU_TPU_CACHE_DIR", str(cache_dir))
    cfg, source, info, buckets = _setup(readback="codes")
    port = _stream(cfg, source, info, buckets, [CPU] * 4)

    jcfg = JConfig(**OPTIONS, readback="codes")
    jsource = JSource(make_cloud(n=8000, seed=7, sr=SR))
    jinfo = jblobs.compute_blobs(jsource, jcfg.fit_grid, jcfg.micro_cells)
    jbuckets = jbucket.make_buckets(jinfo, jcfg.block_cells, jcfg.micro_cells,
                                    max_splats=jcfg.max_device_splats)
    assert ([(tuple(b.cell_lo), tuple(b.cell_hi)) for b in jbuckets]
            == [(tuple(b.cell_lo), tuple(b.cell_hi)) for b in buckets])
    jax_run = list(jstreamer.stream_blocks(
        jsource, jinfo, jbuckets, jcfg, load_cached_caps(jcfg),
        devices=devices[:4]))
    assert len(jax_run) == len(port)
    pc = np.array([(p.num_vertices, p.num_indices, p.num_cells)
                   for _, p in port], np.int64)
    jc = np.array([(j.num_vertices, j.num_indices, j.num_cells)
                   for _, j in jax_run], np.int64)
    assert jc[:, 2].sum() > 1000
    assert (pc == jc).all(axis=1).sum() >= 3 * len(port) // 4
    assert (np.abs(pc - jc) <= np.maximum(jc // 100, 48)).all(), (pc, jc)
    assert (np.abs(pc.sum(0) - jc.sum(0)) <= jc.sum(0) // 500).all()


def test_four_devices_counts_agree_with_the_jax_packages(monkeypatch,
                                                         tmp_path):
    _counts_agree_with_the_jax_packages(monkeypatch, tmp_path)


def test_four_devices_counts_agree_without_the_jax_native_library(
        monkeypatch, tmp_path):
    """The same with the JAX package's native library off, as when its
    first-use build loses a race with another test process. Only the JAX
    side's is turned off: the port's codes readback needs its own."""
    from mlsgpu_tpu import _native as jnative
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    assert jnative.get_lib() is None
    _counts_agree_with_the_jax_packages(monkeypatch, tmp_path)


@pytest.fixture(scope="module")
def small_ply(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("multidevice") / "in.ply")
    ply.write_splats_ply(path, oracle.sphere_cloud(
        [0.7, -0.3, 0.2], 2.0, 2500, 0.5, np.random.default_rng(5)))
    return path


def test_cli_device_threads_output_bytes_identical(small_ply, tmp_path,
                                                   capsys):
    """`--device-threads 3` writes the file `--device-threads 1` writes,
    byte for byte (the header's command comment is the test process's in
    both), and its --timeplot trace has one worker per queue, which
    tools/draw_timeplot and tools/simulate --devices read."""
    from mlsgpu_tpu_torch.tools import draw_timeplot, simulate
    files = []
    trace = str(tmp_path / "trace.txt")
    for threads in (1, 3):
        out = str(tmp_path / f"t{threads}.ply")
        get_registry().clear()
        rc, err = _bounded(lambda: cli.main(
            ["--fit-grid", "0.1", "--fit-smooth", "1", "--levels", "4",
             "--leaf-cells", "8", "--device", "cpu", "--no-progress",
             "--device-threads", str(threads), "--timeplot", trace,
             "-o", out, small_ply]))
        assert err is None and rc == 0, err
        with open(out, "rb") as f:
            files.append(f.read())
    assert files[0] == files[1]
    verts, tris = ply.read_mesh(str(tmp_path / "t3.ply"))
    rep = check_manifold(verts, tris)
    assert rep.is_manifold and rep.num_boundary_edges == 0, rep.reason
    blocks = [get_registry().counter(f"device.blocks.0.{q}").get()
              for q in range(3)]
    assert all(n > 0 for n in blocks), blocks

    with open(trace) as f:
        events = [ln.split() for ln in f if ln.startswith("EVENT ")]
    workers = {e[1] for e in events}
    # the readback wait and the decode of each block are the decode
    # stage's (streamer.stream_blocks(decode=)), a thread per queue
    assert {"loader", "mesher", "decode.0", "device.0.0", "device.0.1",
            "device.0.2"} <= workers
    assert sum(e[2] == "compute" for e in events) == sum(blocks)
    assert sum(e[2] == "decode" for e in events) == sum(blocks)
    capsys.readouterr()
    assert draw_timeplot.main([trace, "-o", str(tmp_path / "t.svg")]) == 0
    assert f"{len(workers)} workers" in capsys.readouterr().out
    assert simulate.main([trace, "--devices", "3"]) == 0
    assert f"{sum(blocks)} blocks" in capsys.readouterr().out


def test_mesh_budget_of_one_image_with_four_workers():
    """--mem-mesh of one image with four workers finishes (the oldest block
    not yet yielded is always admitted) with the same blocks, and
    mem.meshWindow stays within the budget plus one image."""
    cfg, source, info, buckets = _setup()
    roomy = _stream(cfg, source, info, buckets, [CPU] * 4)
    image = max(r.arrays[0].nbytes for _, r in roomy)
    assert get_registry().peak("mem.meshWindow").get_max() >= image > 0
    cfg.mem_mesh = image
    tight = _stream(cfg, source, info, buckets, [CPU] * 4)
    peak = get_registry().peak("mem.meshWindow")
    assert 0 < peak.get_max() <= 2 * image and peak.get() == 0
    assert [b for b, _ in tight] == list(buckets)
    for (_, r1), (_, r2) in zip(roomy, tight):
        assert r1.arrays[0].tobytes() == r2.arrays[0].tobytes()
    _no_streamer_threads()


class FailOn:
    """A block step that raises on the block at `origin` and is the block
    step elsewhere; picklable, as a worker process imports it by name."""

    def __init__(self, origin):
        self.origin = tuple(int(v) for v in origin)

    def __call__(self, splats, valid, region, origin, **kw):
        if tuple(origin) == self.origin:
            raise RuntimeError("block step failed (test)")
        return block_step(splats, valid, region, origin, **kw)


def test_a_failing_worker_ends_the_run_with_its_exception():
    """A block step that raises on the run's third block ends the generator
    with that exception, which names its worker process, within seconds,
    and leaves no thread or process behind."""
    cfg, source, info, buckets = _setup()
    _, readback = trec.prepare_run(cfg, "cpu")
    get_registry().clear()
    t0 = time.monotonic()
    got, err = _bounded(lambda: list(streamer_mod.stream_blocks(
        source, info, buckets, cfg, [CPU] * 4, readback,
        step=FailOn(buckets[2].cell_lo))), seconds=30)
    assert got is None and isinstance(err, RuntimeError)
    assert "block step failed (test)" in str(err)
    assert "raised in worker process device." in "".join(err.__notes__)
    assert time.monotonic() - t0 < 30
    assert sum(_worker_blocks().values()) < len(buckets)
    _no_streamer_threads()
    assert not multiprocessing.active_children()


def test_a_failing_loader_and_a_closed_generator_join_every_thread():
    cfg, source, info, buckets = _setup()
    _, readback = trec.prepare_run(cfg, "cpu")

    def broken():
        yield buckets[0]
        raise OSError("loader failed (test)")

    _, err = _bounded(lambda: list(streamer_mod.stream_blocks(
        source, info, broken(), cfg, [CPU] * 3, readback)), seconds=30)
    assert isinstance(err, OSError) and "loader failed" in str(err)
    _no_streamer_threads()

    gen = streamer_mod.stream_blocks(source, info, buckets, cfg, [CPU] * 3,
                                     readback)
    first = next(gen)
    assert first[0] is buckets[0]
    _bounded(gen.close, seconds=30)
    _no_streamer_threads()


def test_mesh_window_admits_the_oldest_block_over_budget():
    """MeshWindow: a block that is not the oldest waits for room; the
    oldest block not yet yielded passes a full budget."""
    cancel = threading.Event()
    win = streamer_mod.MeshWindow(100, Peak("test.window"), cancel)
    assert win.admit(1, 80)                 # fits
    admitted = []
    t = threading.Thread(target=lambda: admitted.append(win.admit(2, 80)))
    t.start()
    time.sleep(0.3)
    assert not admitted and win.held == 80  # 2 is not the oldest: it waits
    assert win.admit(0, 80) and win.held == 160   # the oldest passes
    win.deposit(0, ("zero",))
    assert win.next_entry() == ("zero",)
    win.release(80)                         # 0 yielded; 1 is the oldest
    time.sleep(0.3)
    assert not admitted                     # 80 + 80 > 100 still
    win.deposit(1, ("one",))
    assert win.next_entry() == ("one",)
    win.release(80)
    t.join(10)
    assert admitted == [True] and win.held == 80
    win.deposit(2, ("two",))
    win.finish(3)
    assert win.next_entry() == ("two",)
    win.release(80)
    assert win.next_entry() is None and win.held == 0
    assert win.peak.get_max() == 160


def test_worker_streams_on_the_cpu():
    """Every (device entry, queue) is a worker; with more than one, each is
    a process with its device's default stream to itself."""
    workers = streamer_mod.device_workers([CPU, CPU], 3)
    assert [(pos, q) for _, pos, q in workers] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert all(dev == CPU for dev, _, _ in workers)


def test_launch_counter_is_thread_safe():
    """8 threads x 1,000 increments through the function the launch uses
    count 8,000."""
    saved = launches.counts()
    launches.reset()

    def bump():
        for _ in range(1000):
            launches.count("mls_field")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert launches.counts()["mls_field"] == 8000
    finally:
        launches.reset()
        launches.add(saved)


def _two_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def test_resolve_devices_takes_every_visible_card(monkeypatch):
    _two_cards(monkeypatch)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert resolve_devices("cuda", 0) == cards
    assert resolve_devices("cuda", 2) == cards
    assert resolve_devices("cuda", 1) == cards[:1]
    assert resolve_devices("cuda:1", 0) == cards[1:]
    assert resolve_devices("cuda:1", 1) == cards[1:]
    assert resolve_devices("cpu", 0) == [CPU] == resolve_devices("cpu", 1)


@pytest.mark.parametrize("name,num", [
    ("cuda", 3),        # more than are visible
    ("cuda:0", 2),      # an indexed card is one device
    ("cuda:2", 0),      # no such card
    ("cpu", 2),
    ("cuda", -1),
    ("tpu", 0),
])
def test_resolve_devices_option_errors(monkeypatch, name, num):
    _two_cards(monkeypatch)
    with pytest.raises(InvalidOption):
        resolve_devices(name, num)


def test_no_card_is_an_error_not_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(InvalidOption):
        resolve_devices("cuda", 0)


def test_validate_device_counts_every_queue_of_a_card(monkeypatch):
    """The estimate is held against a card once per queue on it."""
    cfg = ReconstructConfig(**OPTIONS)
    one = resources.estimate_block_usage(cfg, "codes", "cpu")["total"]
    monkeypatch.setattr(resources, "device_memory_bytes",
                        lambda dev: int(one * 3.5 / 0.9))
    resources.validate_device(cfg, [CPU], "codes", queues=3)
    resources.validate_device(cfg, [CPU, CPU, CPU], "codes")
    with pytest.raises(InvalidOption, match="4 queue"):
        resources.validate_device(cfg, [CPU], "codes", queues=4)
    with pytest.raises(InvalidOption, match="4 queue"):
        resources.validate_device(cfg, [CPU, CPU], "codes", queues=2)


def test_reconstruct_takes_a_device_list(tmp_path):
    """reconstruct(device=[...]) streams over the list as it is."""
    splats = oracle.sphere_cloud([0.7, -0.3, 0.2], 2.0, 2500, 0.5,
                                 np.random.default_rng(5))
    cfg = ReconstructConfig(fit_grid=0.1, fit_smooth=1.0, levels=4,
                            leaf_cells=8, progress=False)
    meshes = []
    for name, device in (("one", "cpu"), ("three", [CPU] * 3)):
        out = str(tmp_path / f"{name}.ply")
        get_registry().clear()
        _, err = _bounded(lambda: trec.reconstruct(
            SequenceSource(splats), cfg, out, device=device))
        assert err is None, err
        meshes.append(ply.read_mesh(out))
    assert sorted(_worker_blocks()) == ["0.0", "1.0", "2.0"]
    np.testing.assert_array_equal(meshes[0][0], meshes[1][0])
    np.testing.assert_array_equal(meshes[0][1], meshes[1][1])
