"""Device workers as processes (mlsgpu_tpu_torch/pipeline/workers.py): a
run with more than one worker runs each in a spawned process, and its
output is bitwise the one-worker run's.

The CPU stands in for the cards, as in tests/test_torch_multidevice.py
(whose small cloud and helpers are used here): a device list may name the
CPU more than once, and each entry gets its own workers. Every streamer
call runs under a bounded wait. The block steps passed with `step=` are
module-level callables, since a worker process imports them by name."""

import dataclasses
import multiprocessing
import os
import pickle
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mlsgpu_tpu_torch import cli
from mlsgpu_tpu_torch.io import ply
from mlsgpu_tpu_torch.io.splat_set import SequenceSource
from mlsgpu_tpu_torch.ops import launches
from mlsgpu_tpu_torch.ops.block import block_step, block_step_staged
from mlsgpu_tpu_torch.pipeline import reconstruct as trec
from mlsgpu_tpu_torch.pipeline import resources
from mlsgpu_tpu_torch.pipeline import streamer as streamer_mod
from mlsgpu_tpu_torch.pipeline import worker_start, workers
from mlsgpu_tpu_torch.pipeline.mesh_filter import (DeviceFilterChain,
                                                   DeviceScaleBias)
from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.utils import misc, timeplot
from mlsgpu_tpu_torch.utils.errors import InvalidOption
from mlsgpu_tpu_torch.utils.statistics import Registry, get_registry

from tests import oracle
from tests.test_torch_multidevice import (CPU, HANG_S, OPTIONS, SR,
                                          _bounded, _no_streamer_threads,
                                          _setup, _worker_blocks, make_cloud)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mlsgpu_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here, and so in every worker process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: The ids of the worker processes started in this module's tests: they
#: are the worker server's children, not this process's, so a check that
#: none outlives its run looks for them by id (_alive).
STARTED = []


@pytest.fixture(autouse=True, scope="module")
def _note_worker_pids():
    start = workers.WorkerProcess.start

    def noted(self):
        start(self)
        if self.proc.pid is not None:
            STARTED.append(self.proc.pid)

    workers.WorkerProcess.start = noted
    yield
    workers.WorkerProcess.start = start


def _alive(pids):
    """Those of `pids` that are running processes (not ended, not
    zombies)."""
    out = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state not in ("Z", "X"):
            out.append(pid)
    return out


class CheckedStep:
    """The staged block step, which also counts one kernel launch per block
    (the CPU path launches none) and raises if the process has imported
    jax or the JAX package."""

    def __call__(self, *args, **kw):
        bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
        if bad:
            raise AssertionError(f"a worker process imported {bad[:5]}")
        launches.count("mls_field")
        return block_step_staged(*args, **kw)


class KillOn:
    """The block step, but the process kills itself with SIGKILL on the
    block at `origin`."""

    def __init__(self, origin):
        self.origin = tuple(int(v) for v in origin)

    def __call__(self, splats, valid, region, origin, **kw):
        if tuple(origin) == self.origin:
            os.kill(os.getpid(), signal.SIGKILL)
        return block_step(splats, valid, region, origin, **kw)


#: The wait SyncStep makes inside its step's `sync` hook, seconds.
SYNC_WAIT_S = 0.05


class SyncStep:
    """The block step, with a wait of SYNC_WAIT_S inside its `sync` hook,
    as a step on a card waits there for the stream."""

    def __call__(self, *args, sync, **kw):
        with sync():
            time.sleep(SYNC_WAIT_S)
        return block_step(*args, sync=sync, **kw)


@pytest.fixture(scope="module")
def small():
    """The multidevice tests' cloud, its first 8 buckets: each worker
    process pays an interpreter's start, so the runs here are short."""
    cfg, source, info, buckets = _setup()
    return cfg, source, info, buckets[:8]


def _run(cfg, source, info, buckets, devices, seconds=HANG_S, **kw):
    """stream_blocks under a bounded wait, statistics from 0: (blocks,
    exception, seconds taken). No process started by the run, Python's
    resource tracker included, is left when it ends, however it ends."""
    _, readback = trec.prepare_run(cfg, "cpu", kw.get("device_filter"))
    get_registry().clear()
    before, n0 = misc.child_pids(), len(STARTED)
    t0 = time.monotonic()
    got, err = _bounded(lambda: list(streamer_mod.stream_blocks(
        source, info, buckets, cfg, devices, readback, **kw)), seconds)
    dt = time.monotonic() - t0
    assert misc.child_pids() <= before
    assert not _alive(STARTED[n0:])
    return got, err, dt


@pytest.fixture(scope="module")
def one_run(small):
    """The one-worker run, with the worker processes alive at each of its
    yields and its statistics."""
    cfg, source, info, buckets = small
    _, readback = trec.prepare_run(cfg, "cpu")
    get_registry().clear()
    children, got = [], []

    def run():
        for item in streamer_mod.stream_blocks(source, info, buckets, cfg,
                                               CPU, readback):
            children.extend(multiprocessing.active_children())
            got.append(item)

    _, err = _bounded(run)
    assert err is None, err
    return got, children, get_registry().to_dict()


@pytest.fixture(scope="module")
def one(one_run):
    """The one-worker run every multi-worker run must repeat bit for bit."""
    return one_run[0]


def _assert_bitwise(got, ref, buckets):
    assert [b for b, _ in got] == list(buckets) == [b for b, _ in ref]
    for (_, r1), (_, r2) in zip(ref, got):
        assert r1.readback == r2.readback and r1.fmt == r2.fmt
        np.testing.assert_array_equal(r1.counts, r2.counts)
        assert len(r1.arrays) == len(r2.arrays) >= 1
        for a1, a2 in zip(r1.arrays, r2.arrays):
            assert a1.dtype == a2.dtype and a1.tobytes() == a2.tobytes()


@pytest.mark.parametrize("entries,threads", [(2, 1), (4, 1), (2, 2)],
                         ids=["2", "4", "2x2"])
def test_process_workers_yield_bitwise_the_one_worker_run(small, one,
                                                          entries, threads):
    """2 and 4 device entries, and 2 with --device-threads 2: every block
    in the loader's order, bitwise the one-worker run's, every worker a
    process that ran a block."""
    cfg, source, info, buckets = small
    cfg = dataclasses.replace(cfg, device_threads=threads)
    got, err, _ = _run(cfg, source, info, buckets, [CPU] * entries)
    assert err is None, err
    _assert_bitwise(got, one, buckets)
    blocks = _worker_blocks()
    assert sorted(blocks) == sorted(f"{p}.{q}" for p in range(entries)
                                    for q in range(threads))
    assert all(n > 0 for n in blocks.values()), blocks
    assert get_registry().counter("workers.spawned").get() == \
        entries * threads
    _no_streamer_threads()


def test_raw_readback_and_a_device_filter_through_processes(small):
    """The raw readback's four arrays, with a device filter pickled into
    each process, are bitwise the one-worker run's."""
    cfg, source, info, buckets = small
    filt = DeviceFilterChain([DeviceScaleBias(2.0, (0.5, -1.0, 0.25))])
    runs = []
    for devices in (CPU, [CPU] * 2):
        got, err, _ = _run(cfg, source, info, buckets, devices,
                           device_filter=filt)
        assert err is None, err
        runs.append(got)
    assert all(r.readback == "raw" and len(r.arrays) == 4
               for _, r in runs[1])
    _assert_bitwise(runs[1], runs[0], buckets)
    _no_streamer_threads()


def test_one_worker_spawns_no_process(small, one_run):
    """One worker keeps its block steps in this process."""
    got, children, stats = one_run
    assert len(got) == len(small[3]) and not children
    assert "workers.spawned" not in stats
    assert stats["device.blocks.0.0"]["total"] == len(got)


@pytest.fixture(scope="module")
def checked(small, tmp_path_factory):
    """Two worker processes with CheckedStep, a --timeplot trace and no
    images read back: (blocks, statistics, trace events, launches, the run's
    start and end on the monotonic clock)."""
    cfg, source, info, buckets = small
    trace = str(tmp_path_factory.mktemp("workers") / "trace.txt")
    saved = launches.counts()
    launches.reset()
    timeplot.init(trace)
    try:
        t0 = time.monotonic()
        got, err, _ = _run(cfg, source, info, buckets, [CPU] * 2,
                           read_images=False, step=CheckedStep())
        t1 = time.monotonic()
        launched = launches.counts()["mls_field"]
    finally:
        timeplot.init(None)
        launches.reset()
        launches.add(saved)
    assert err is None, err
    with open(trace) as f:
        events = [ln.split() for ln in f if ln.startswith("EVENT ")]
    return got, get_registry().to_dict(), events, launched, (t0, t1)


def test_counts_only_through_processes(small, one, checked):
    """With read_images false a block carries its counts alone, the
    one-worker run's."""
    got = checked[0]
    assert [b for b, _ in got] == [b for b, _ in one]
    for (_, r1), (_, r2) in zip(one, got):
        np.testing.assert_array_equal(r1.counts, r2.counts)
        assert r2.arrays == ()


def test_worker_statistics_reach_the_parent(small, checked):
    """The per-worker blocks sum to the bucket count; device.time,
    dispatch.h2d, device.occTiles and every --statistics-device stage have
    one sample per block; both processes reported their start."""
    n = len(small[3])
    stats = checked[1]
    blocks = {k: v["total"] for k, v in stats.items()
              if k.startswith("device.blocks.")}
    assert sorted(blocks) == ["device.blocks.0.0", "device.blocks.1.0"]
    assert sum(blocks.values()) == n and min(blocks.values()) > 0
    for name in ("device.time", "dispatch.h2d", "device.occTiles"):
        assert stats[name]["n"] == n, name
    stages = [k for k in stats if k.startswith("device.")
              and k.endswith(".time") and k != "device.time"]
    assert len(stages) >= 5 and all(stats[k]["n"] >= n for k in stages), \
        stages
    assert stats["readback.mode.codes"]["total"] == n
    assert stats["workers.spawned"]["total"] == 2
    assert stats["workers.startTime"]["n"] == 2
    assert stats["workers.importTime"]["n"] == 2
    assert stats["workers.startTime"]["sum"] >= \
        stats["workers.importTime"]["sum"] > 0
    per_worker = sum(v["sum"] for k, v in stats.items()
                     if k.startswith("device.workerTime."))
    assert per_worker >= stats["device.time"]["sum"] > 0


def test_worker_launches_reach_the_parents_count(small, checked):
    """The launches a worker process counts arrive in this process's
    count of the field kernel (ops/launches.py): one per block here."""
    assert checked[3] == len(small[3])


def test_worker_compute_spans_in_the_timeplot(small, checked):
    """Each block's compute span, timed in its process, is an EVENT of its
    worker in the trace, inside the run on the shared monotonic clock."""
    events, (t0, t1) = checked[2], checked[4]
    compute = [e for e in events if e[2] == "compute"]
    assert {e[1] for e in compute} == {"device.0.0", "device.1.0"}
    assert len(compute) == len(small[3])
    assert all(t0 <= float(e[3]) <= float(e[4]) <= t1 for e in compute)
    assert {"loader", "readback"} <= {e[1] for e in events}


@pytest.mark.parametrize("entries", [1, 2], ids=["thread", "processes"])
def test_the_steps_waits_are_sync_spans_inside_compute(small, tmp_path,
                                                      entries):
    """The streamer hands the block step a `sync` hook: its waits are
    summed into device.syncWait, one sample a block, in a worker thread
    and in worker processes alike, with device.cpu beside device.time,
    which still spans the copy and the whole step. On a worker thread the
    trace has the `h2d` and `sync` actions inside `compute`: the worker's
    intervals touch end to end and add up to device.time, the sync
    intervals to device.syncWait. A worker process keeps no spans but its
    compute."""
    cfg, source, info, buckets = small
    trace = str(tmp_path / "trace.txt")
    timeplot.init(trace)
    try:
        got, err, _ = _run(cfg, source, info, buckets, [CPU] * entries,
                           read_images=False, step=SyncStep())
    finally:
        timeplot.init(None)
    assert err is None, err
    n = len(buckets)
    tick = 1.0 / os.sysconf("SC_CLK_TCK")
    stats = get_registry().to_dict()
    for name in ("device.time", "device.cpu", "device.syncWait",
                 "dispatch.h2d"):
        assert stats[name]["n"] == n, name
    wall, cpu, wait, h2d = (stats[k]["sum"] for k in (
        "device.time", "device.cpu", "device.syncWait", "dispatch.h2d"))
    assert wait >= n * SYNC_WAIT_S
    assert wall >= h2d + wait
    assert cpu <= wall - wait + n * tick
    with open(trace) as f:
        events = [ln.split() for ln in f if ln.startswith("EVENT ")]
    mine = sorted((float(e[3]), float(e[4]), e[2]) for e in events
                  if e[1].startswith("device."))
    if entries == 2:
        assert [a for _, _, a in mine] == ["compute"] * n
        return
    assert sum(a == "sync" for _, _, a in mine) == n
    assert sum(a == "h2d" for _, _, a in mine) == n
    assert sum(a == "compute" for _, _, a in mine) >= 3 * n
    assert all(x[1] <= y[0] for x, y in zip(mine, mine[1:]))
    assert sum(hi - lo for lo, hi, _ in mine) == pytest.approx(wall,
                                                               abs=1e-6)
    assert sum(hi - lo for lo, hi, a in mine if a == "sync") == \
        pytest.approx(wait, abs=1e-6)


def test_a_worker_process_imports_neither_jax_nor_the_jax_package(checked):
    """CheckedStep raises in a process that imported jax or mlsgpu_tpu;
    this process has both, so the steps ran elsewhere, and clean."""
    assert "jax" in sys.modules
    assert checked[1]["workers.spawned"]["total"] == 2


def test_a_killed_worker_ends_the_run_with_its_exit_code(small):
    """A worker process killed by SIGKILL ends the run within seconds with
    an error that names it and its exit code; none is left."""
    cfg, source, info, buckets = small
    got, err, dt = _run(cfg, source, info, buckets, [CPU] * 2, seconds=30,
                        step=KillOn(buckets[2].cell_lo))
    assert got is None and isinstance(err, workers.WorkerDied), err
    assert "exited with code -9 (SIGKILL)" in str(err)
    assert "worker process device." in str(err)
    assert dt < 30
    assert sum(_worker_blocks().values()) < len(buckets)
    _no_streamer_threads()


def test_a_worker_that_cannot_start_is_an_error_not_the_cpu(small):
    """Worker processes on a card this machine does not have fail at their
    start; the run raises, naming a worker, and runs no block anywhere."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the workers would start")
    cfg, source, info, buckets = small
    card = torch.device("cuda", 0)
    got, err, dt = _run(cfg, source, info, buckets, [card] * 2, seconds=30)
    assert got is None and err is not None
    assert "raised in worker process device." in "".join(
        getattr(err, "__notes__", []))
    assert dt < 30
    assert not _worker_blocks() or sum(_worker_blocks().values()) == 0
    assert "device.time" not in get_registry().to_dict()
    _no_streamer_threads()


def test_closing_the_generator_ends_every_worker_process(small):
    cfg, source, info, buckets = small
    _, readback = trec.prepare_run(cfg, "cpu")
    before, n0 = misc.child_pids(), len(STARTED)
    gen = streamer_mod.stream_blocks(source, info, buckets, cfg, [CPU] * 2,
                                     readback)
    first, err = _bounded(lambda: [next(gen), next(gen)])
    assert err is None and [b for b, _ in first] == list(buckets[:2])
    assert len(multiprocessing.active_children()) == 2
    _, err = _bounded(gen.close, seconds=30)
    assert err is None
    _no_streamer_threads()
    assert misc.child_pids() <= before
    assert len(STARTED) - n0 == 2 and not _alive(STARTED[n0:])


def _decoded(block, bucket):
    """The decode stage's work in these tests: the mesher's input, beside
    the HostBlock it came from."""
    return block, trec.block_result_to_input(block, bucket)


@pytest.mark.parametrize("decode", [None, _decoded],
                         ids=["images", "decoded"])
def test_tight_budgets_hold_with_four_processes(small, one, decode):
    """Budgets of one block's splats and one block's held bytes with four
    worker processes: the same blocks, and each peak within its budget
    plus one block's bytes (the one item a budget always admits). With a
    decode stage --mem-mesh holds each block's image and its decoded mesh
    (streamer.decoded_bytes) from the start of its copy to its yield."""
    cfg, source, info, buckets = small
    # the bucket budget may not exceed the load budget (config.validate)
    block = max(max(b.num_splats for b in buckets) * streamer_mod.SPLAT_BYTES,
                32 * cfg.max_device_splats)
    image = max(r.arrays[0].nbytes
                + (0 if decode is None else streamer_mod.decoded_bytes(
                    r.counts)) for _, r in one)
    tight = dataclasses.replace(cfg, mem_bucket_splats=32 *
                                cfg.max_device_splats, mem_load_splats=block,
                                mem_host_splats=block, mem_mesh=image)
    got, err, _ = _run(tight, source, info, buckets, [CPU] * 4,
                       decode=decode)
    assert err is None, err
    if decode is not None:
        got = [(b, r) for b, (r, _) in got]
    _assert_bitwise(got, one, buckets)
    stats = get_registry()
    assert image <= stats.peak("mem.meshWindow").get_max() <= 2 * image
    for name in ("mem.loadQueue", "mem.hostSplats"):
        assert 0 < stats.peak(name).get_max() <= 2 * block, name
        assert stats.peak(name).get() == 0, name
    _no_streamer_threads()


def test_module_cli_with_two_device_threads(tmp_path):
    """`python -m mlsgpu_tpu_torch --device-threads 2` (a `-m` main that no
    worker process re-runs) writes the mesh of `--device-threads 1`, and
    its statistics show both workers and one import of torch for both."""
    path = str(tmp_path / "in.ply")
    ply.write_splats_ply(path, oracle.sphere_cloud(   # 8 blocks
        [0.7, -0.3, 0.2], 1.0, 1500, 0.3, np.random.default_rng(5)))
    args = ["--device", "cpu", "--fit-grid", "0.1", "--fit-smooth", "1",
            "--levels", "3", "--leaf-cells", "8", "--no-progress"]
    one = str(tmp_path / "one.ply")
    rc, err = _bounded(lambda: cli.main([*args, "-o", one, path]))
    assert err is None and rc == 0, err
    two = str(tmp_path / "two.ply")
    proc = subprocess.run(
        [sys.executable, "-m", "mlsgpu_tpu_torch", *args, "--statistics",
         "--device-threads", "2", "-o", two, path],
        cwd=ROOT, capture_output=True, text=True, timeout=HANG_S,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    for a, b in zip(ply.read_mesh(one), ply.read_mesh(two)):
        np.testing.assert_array_equal(a, b)
    assert "device.blocks.0.1:" in proc.stdout
    assert "workers.spawned: 2" in proc.stdout
    assert "workers.readyWait:" in proc.stdout
    # torch was imported once, by the worker server, and no process
    # re-imported the main module (a package's __main__)
    assert re.search(r"^workers\.torchTime: .* \[1\]$", proc.stdout, re.M)
    assert re.search(r"^workers\.cudaTime", proc.stdout, re.M) is None
    assert "workers.mainImported: 0" in proc.stdout


def _early_start_run(tmp_path, monkeypatch, threads, fail_in=None):
    """reconstruct() of the multidevice tests' cloud on the CPU with
    `threads` device threads, the blob pass wrapped to note (whether the
    worker server was launched, whether this process has a child process
    it did not have before the run) when it starts; `fail_in` names a
    pipeline module function ("blobs_mod.compute_blobs" or
    "bucket_mod.make_buckets") that raises instead. Returns (the notes,
    the run's exception). No process started by the run is left."""
    cfg = ReconstructConfig(**{**OPTIONS, "device_threads": threads})
    source = SequenceSource(make_cloud(n=8000, seed=7, sr=SR))
    notes = []
    real = trec.blobs_mod.compute_blobs
    before, n0 = misc.child_pids(), len(STARTED)

    def note():
        notes.append((worker_start.launched is not None,
                      bool(misc.child_pids() - before)))

    def blob_pass(*a, **kw):
        note()
        return real(*a, **kw)

    def boom(*a, **kw):
        note()
        raise RuntimeError("failed before the stream")

    monkeypatch.setattr(trec.blobs_mod, "compute_blobs", blob_pass)
    if fail_in is not None:
        mod, fn = fail_in.split(".")
        monkeypatch.setattr(getattr(trec, mod), fn, boom)
    get_registry().clear()
    _, err = _bounded(lambda: trec.reconstruct(
        source, cfg, str(tmp_path / "out.ply"), device="cpu"))
    assert misc.child_pids() <= before
    assert not _alive(STARTED[n0:])
    return notes, err


@pytest.mark.parametrize("threads", [1, 2])
def test_worker_processes_start_before_the_blob_pass(tmp_path, monkeypatch,
                                                     threads):
    """Two device threads: reconstruct starts the worker server and asks
    it for both worker processes before the blob pass, so their start runs
    beside it and bucketing, and stream_blocks records how long it then
    waited for them (workers.readyWait). One: nothing starts early,
    nothing waits."""
    notes, err = _early_start_run(tmp_path, monkeypatch, threads)
    assert err is None, err
    stats = get_registry().to_dict()
    if threads == 1:
        assert notes == [(False, False)]
        assert "workers.readyWait" not in stats
    else:
        assert notes == [(True, True)]
        assert stats["workers.spawned"]["total"] == 2
        assert stats["workers.readyWait"]["n"] == 1
        assert sum(stats[f"device.blocks.0.{q}"]["total"]
                   for q in range(2)) > 0


@pytest.mark.parametrize("fail_in", ["blobs_mod.compute_blobs",
                                     "bucket_mod.make_buckets"])
def test_a_failure_before_the_stream_stops_the_early_workers(
        tmp_path, monkeypatch, fail_in):
    """The blob pass or bucketing raises after the worker processes have
    started: the run raises that error and leaves no child process."""
    notes, err = _early_start_run(tmp_path, monkeypatch, 2, fail_in)
    assert isinstance(err, RuntimeError), err
    assert "failed before the stream" in str(err)
    assert notes[0] == (True, True)


def test_a_rank_starts_its_workers_before_its_blob_pass(monkeypatch):
    """A distributed rank (parallel/multihost.py) with two device threads
    starts its worker processes before its blob pass and stops them when
    that pass raises: no child process is left."""
    from mlsgpu_tpu_torch.parallel import multihost
    cfg = ReconstructConfig(**{**OPTIONS, "device_threads": 2})
    source = SequenceSource(make_cloud(n=8000, seed=7, sr=SR))
    notes = []

    def boom(*a, **kw):
        notes.append(worker_start.launched is not None)
        raise RuntimeError("failed before the stream")

    monkeypatch.setattr(multihost, "distributed_blobs", boom)
    transport, = multihost.LocalTransport.make(1)
    before, n0 = misc.child_pids(), len(STARTED)
    _, err = _bounded(lambda: multihost.reconstruct_distributed(
        source, cfg, "unused.ply", transport, device="cpu"))
    assert isinstance(err, RuntimeError) and notes == [True], (err, notes)
    assert misc.child_pids() <= before
    assert not _alive(STARTED[n0:])


def test_exceptions_cross_the_process_boundary():
    """A picklable exception goes as it is; one that is not becomes a
    RuntimeError with its type and text."""
    err = ValueError("bad block")
    assert workers._portable(err) is err

    class Local(Exception):
        pass

    out = workers._portable(Local("no pickle"))
    assert type(out) is RuntimeError
    assert str(out) == "Local: no pickle"
    pickle.dumps(out)


def test_statistics_delta_round_trip():
    """A worker's counters, variables and timers merge into this process's
    registry under their kinds and names."""
    child = Registry()
    child.counter("c").add(3)
    child.variable("v").add(2.0)
    with child.timer("t"):
        pass
    delta = workers._stat_delta(child)
    assert {k for k, _, _ in delta} == {"counter", "variable", "timer"}
    get_registry().clear()
    workers.merge_stat_delta(delta)
    workers.merge_stat_delta(delta)
    stats = get_registry()
    assert stats.counter("c").get() == 6
    assert stats.variable("v").n == 2 and stats.variable("v").sum == 4.0
    assert stats.timer("t").n == 2     # still usable as a timer here


@pytest.mark.parametrize("entries,queues,fits", [
    (1, 1, True),     # one worker: no process, no extra context
    (1, 3, False),    # three processes: three contexts more
    (1, 2, True),
])
def test_validate_device_counts_a_context_per_worker_process(
        monkeypatch, entries, queues, fits):
    """On a card, each worker process adds WORKER_CONTEXT_BYTES to its
    block step's estimate; a one-worker run adds none. (The seam kernels'
    reserve, read from the card at run time, is stubbed.)"""
    cfg = ReconstructConfig(**OPTIONS)
    reserve = 64 * 2048 * 132
    monkeypatch.setattr(resources, "seam_local_reserve", lambda dev: reserve)
    one = resources.estimate_block_usage(cfg, "codes", "cuda",
                                         reserve)["total"]
    limit = (3 * one + 2 * workers.WORKER_CONTEXT_BYTES) / 0.9
    monkeypatch.setattr(resources, "device_memory_bytes",
                        lambda dev: int(limit))
    card = [torch.device("cuda", 0)] * entries
    if fits:
        resources.validate_device(cfg, card, "codes", queues=queues)
    else:
        with pytest.raises(InvalidOption, match=f"{queues} queue"):
            resources.validate_device(cfg, card, "codes", queues=queues)


def test_child_pids_sees_a_child_until_it_is_waited_for():
    """utils.misc.child_pids, which the checks above and chip_smoke.py use
    to find processes left running: a child is listed while it runs and
    until it is reaped, and not after."""
    before = misc.child_pids()
    proc = subprocess.Popen([sys.executable, "-c",
                             "import sys; sys.stdin.read()"],
                            stdin=subprocess.PIPE)
    try:
        assert proc.pid in misc.child_pids() - before
    finally:
        proc.communicate(timeout=30)
    assert proc.pid not in misc.child_pids()


def _convert_in_worker(conn, raw, grid):
    """A forked worker process's frame conversion of `raw`, sent back as
    bytes."""
    from mlsgpu_tpu_torch.core.splat import block_inputs
    splats, valid = block_inputs(raw.numpy(), grid)
    conn.send((splats.tobytes(), valid.tobytes()))


def test_worker_frame_conversion_is_bitwise_the_parents(small):
    """A worker process forked from the worker server converts a bucket's
    world-frame splats, read once into shared memory by the loader
    (streamer.load_bucket_shared), to exactly the bytes of the loader's
    own conversion (streamer.load_bucket) for a worker thread."""
    cfg, source, info, buckets = small
    b = max(buckets, key=lambda b: b.num_splats)
    raw = streamer_mod.load_bucket_shared(source, info, b)
    assert raw.is_shared() and len(raw) == b.num_splats
    splats, valid = streamer_mod.load_bucket(source, info, b)
    ctx = worker_start.context()
    before = misc.child_pids()
    worker_start.hold_server()
    try:
        mine, theirs = ctx.Pipe()
        proc = ctx.Process(target=_convert_in_worker, daemon=True,
                           args=(theirs, raw, info.grid))
        proc.start()
        theirs.close()
        got = mine.recv()
        proc.join(30)
    finally:
        worker_start.release_server()
    assert got == (splats.tobytes(), valid.tobytes())
    assert misc.child_pids() <= before


def test_the_server_and_tracker_stop_with_the_last_holder():
    """The worker server and Python's resource tracker, which its start
    launches, run while any holder holds them and stop with the last."""
    before = misc.child_pids()
    worker_start.hold_server()
    worker_start.hold_server()
    try:
        assert worker_start.launched is not None
        assert len(misc.child_pids() - before) >= 1
        worker_start.release_server()
        assert worker_start.launched is not None
        assert len(misc.child_pids() - before) >= 1
    finally:
        worker_start.release_server()
    assert worker_start.launched is None
    assert misc.child_pids() <= before


def test_a_server_that_cannot_start_is_an_error(small, monkeypatch):
    """The worker server fails to start: the run raises an error that
    names it, starts no worker and runs no block anywhere."""
    from multiprocessing import forkserver

    def refuse():
        raise OSError("no server here")

    monkeypatch.setattr(forkserver, "ensure_running", refuse)
    cfg, source, info, buckets = small
    got, err, _ = _run(cfg, source, info, buckets, [CPU] * 2, seconds=30)
    assert got is None and "the worker server could not start" in str(err)
    assert "device.time" not in get_registry().to_dict()
    _no_streamer_threads()


def test_a_worker_the_server_cannot_fork_is_an_error(small, monkeypatch):
    """The server cannot start a worker process: the run raises an error
    that names the worker, and runs no block anywhere."""
    cfg, source, info, buckets = small
    real = workers.WorkerProcess.start

    def refuse(self):
        if self.name == "device.1.0":
            self.proc.start = lambda: (_ for _ in ()).throw(
                EOFError("the server closed the connection"))
        real(self)

    monkeypatch.setattr(workers.WorkerProcess, "start", refuse)
    got, err, _ = _run(cfg, source, info, buckets, [CPU] * 2, seconds=60)
    assert got is None
    assert "worker process device.1.0 could not start" in str(err)
    assert not _worker_blocks() or sum(_worker_blocks().values()) == 0
    _no_streamer_threads()


def _shm_fds():
    """This process's open file descriptors of shared memory."""
    out = set()
    for fd in os.listdir("/proc/self/fd"):
        try:
            if "/dev/shm/" in os.readlink(f"/proc/self/fd/{fd}"):
                out.add(fd)
        except OSError:
            pass
    return out


def test_a_cancelled_run_releases_the_loaders_shared_buffers(small):
    """The loader reads buckets straight into shared memory for the worker
    processes; closing the run after one block leaves none of those
    buffers open here."""
    import gc
    cfg, source, info, buckets = small
    _, readback = trec.prepare_run(cfg, "cpu")
    gc.collect()
    before = _shm_fds()
    gen = streamer_mod.stream_blocks(source, info, buckets, cfg, [CPU] * 2,
                                     readback)
    first, err = _bounded(lambda: next(gen))
    assert err is None
    del first
    _, err = _bounded(gen.close, seconds=30)
    assert err is None
    gc.collect()
    assert _shm_fds() <= before
    _no_streamer_threads()


@pytest.mark.parametrize("device,threads,cards,cuda,nvidia,want", [
    ("cuda", 1, 0, "0,1", None, True),      # every card, two seen
    ("cuda", 1, 0, "1", "0,1,2", False),    # CUDA_VISIBLE_DEVICES rules
    ("cuda", 1, 1, "0,1,2", None, False),   # --num-devices 1
    ("cuda:0", 1, 0, "0,1", None, False),   # one indexed card
    ("cuda", 1, 0, "", None, False),        # no card seen
    ("cuda", 1, 0, None, "7", False),       # a container of one card
    ("cuda", 1, 0, None, "4,5,6,7", True),  # a container of four
    ("cuda", 1, 0, None, "all", False),     # no count given
    ("cuda", 1, 0, None, None, False),      # nothing tells
    ("cpu", 2, 0, "", None, True),          # two queues
    ("cuda:1", 1, 3, "0", None, True),      # --num-devices 3: errs later
])
def test_several_workers_from_the_options_and_the_cards_seen(
        monkeypatch, device, threads, cards, cuda, nvidia, want):
    """What the command line knows before torch is imported: whether to
    start the worker server at once (worker_start.several_workers)."""
    for var, value in (("CUDA_VISIBLE_DEVICES", cuda),
                       ("NVIDIA_VISIBLE_DEVICES", nvidia)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    cfg = ReconstructConfig(**{**OPTIONS, "device_threads": threads,
                               "num_devices": cards})
    assert worker_start.several_workers(cfg, device) is want


#: The readback modes of the end-to-end runs below: the CLI's options and
#: whether a device filter (which makes the readback raw) is given.
MODES = {"codes": ("codes", False), "packed": ("packed", False),
         "raw": ("auto", True)}


@pytest.fixture(scope="module")
def end_to_end(tmp_path_factory):
    """reconstruct() of a small sphere (8 blocks) on the CPU in every
    readback mode with 1, 2 and 4 workers, the threads that decoded each
    block noted: {(mode, workers): (mesh arrays, statistics, the decoding
    threads' names)}."""
    import threading
    splats = oracle.sphere_cloud([0.7, -0.3, 0.2], 1.0, 1500, 0.3,
                                 np.random.default_rng(5))
    real = trec.block_result_to_input
    names = []

    def noted(result, bucket):
        names.append(threading.current_thread().name)
        return real(result, bucket)

    out = {}
    tmp = tmp_path_factory.mktemp("end_to_end")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trec, "block_result_to_input", noted)
        for mode, (readback, filtered) in MODES.items():
            for n in (1, 2, 4):
                cfg = ReconstructConfig(fit_grid=0.1, fit_smooth=1.0,
                                        levels=3, leaf_cells=8,
                                        progress=False, device_threads=n,
                                        readback=readback)
                filt = (DeviceFilterChain([DeviceScaleBias(
                    2.0, (0.5, -1.0, 0.25))]) if filtered else None)
                path = str(tmp / f"{mode}_{n}.ply")
                get_registry().clear()
                names.clear()
                before, n0 = misc.child_pids(), len(STARTED)
                _, err = _bounded(lambda: trec.reconstruct(
                    SequenceSource(splats), cfg, path, device="cpu",
                    device_filter=filt))
                assert err is None, err
                assert misc.child_pids() <= before
                assert not _alive(STARTED[n0:])
                out[mode, n] = (ply.read_mesh(path),
                                get_registry().to_dict(), list(names))
    return out


@pytest.mark.parametrize("workers", [2, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_every_worker_count_writes_the_one_queue_mesh(end_to_end, mode,
                                                      workers):
    """The whole run through the decode stage with 2 and 4 worker
    processes writes the one-queue run's mesh bit for bit, in the codes,
    packed and raw (device filter) readbacks."""
    one, stats, _ = end_to_end[mode, 1]
    got, got_stats, _ = end_to_end[mode, workers]
    assert len(one[0]) > 0
    for a, b in zip(one, got):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got_stats["workers.spawned"]["total"] == workers
    assert f"readback.mode.{'raw' if mode == 'raw' else mode}" in got_stats
    assert "workers.spawned" not in stats


def test_no_decode_runs_on_the_mesher_thread(end_to_end):
    """Every block is decoded once, on a thread of the decode stage (one
    per worker, at most half the cores), never on the mesher's."""
    for (mode, n), (_, stats, names) in end_to_end.items():
        blocks = stats["bucket.count"]["total"]
        threads = streamer_mod.decode_threads(n)
        assert stats["readback.decodeThreads"]["total"] == threads
        assert len(names) == blocks > 0, (mode, n)
        assert set(names) <= {f"decode.{i}" for i in range(threads)}, names


def test_pace_statistics_reach_the_parent(end_to_end):
    """What sets pass 1's pace is recorded per block: each worker's wait
    for a slot of its window (workers.slotWait: one sample per block it
    pulls and one when it finds none left), the producer's wait for room
    on the mesher's queue (consumer.wait), the mesher's busy time
    (consumer.busy); readback.decode, readback.decodeCpu and mesher.time
    keep one sample per block wherever they now run."""
    for (mode, n), (_, stats, _) in end_to_end.items():
        blocks = stats["bucket.count"]["total"]
        assert blocks <= stats["workers.slotWait"]["n"] <= blocks + n
        for name in ("consumer.wait", "consumer.busy", "readback.decode",
                     "readback.decodeCpu", "mesher.time"):
            assert stats[name]["n"] == blocks, (mode, n, name)
        assert stats["consumer.busy"]["sum"] >= stats["mesher.time"]["sum"]


def test_cpu_time_and_waits_one_sample_a_block(end_to_end):
    """device.cpu, device.syncWait, mesher.cpu, loader.cpu and
    readback.decodeCpu have one sample a block in every readback mode with
    1, 2 and 4 workers; device.time holds the copy and the waits; each
    span's CPU time is at most its wall time and a clock tick a block
    (the decode's span holds readback.decode's timer and a few calls
    besides); the process's CPU time over pass 1 holds every spanned
    thread's of this process (the step's too with one worker, which is a
    thread here), and each phase's is one sample."""
    tick = 1.0 / os.sysconf("SC_CLK_TCK")
    for (mode, n), (_, stats, _) in end_to_end.items():
        blocks = stats["bucket.count"]["total"]
        for name in ("device.cpu", "device.syncWait", "mesher.cpu",
                     "loader.cpu", "readback.decodeCpu"):
            assert stats[name]["n"] == blocks, (mode, n, name)
        s = {k: v["sum"] for k, v in stats.items() if "sum" in v}
        assert s["device.time"] >= s["dispatch.h2d"] + s["device.syncWait"]
        for cpu, wall in (("device.cpu", "device.time"),
                          ("mesher.cpu", "mesher.time"),
                          ("loader.cpu", "loader.time"),
                          ("readback.decodeCpu", "readback.decode")):
            assert s[cpu] <= s[wall] + blocks * tick, (mode, n, cpu)
        spanned = s["loader.cpu"] + s["readback.decodeCpu"] + s["mesher.cpu"]
        if n == 1:
            spanned += s["device.cpu"]
        assert s["pass1.cpu"] >= spanned - tick, (mode, n)
        for phase in ("pass0", "bucket", "pass1", "write"):
            assert stats[f"{phase}.cpu"]["n"] == 1, (mode, n, phase)


def test_the_mesher_gets_blocks_in_the_loaders_order(small):
    """Two workers and a decode that is slow on the first block: the
    second block's decode finishes first, and the generator still yields
    every block in the loader's order, each with its own decode."""
    import threading
    cfg, source, info, buckets = small
    done = []
    lock = threading.Lock()

    def slow_first(block, bucket):
        seq = next(i for i, b in enumerate(buckets) if b is bucket)
        if seq == 0:
            time.sleep(2.0)
        with lock:
            done.append(seq)
        return bucket, block

    got, err, _ = _run(cfg, source, info, buckets, [CPU] * 2,
                       decode=slow_first)
    assert err is None, err
    assert done.index(1) < done.index(0)
    assert [b for b, _ in got] == list(buckets)
    assert all(b is d for b, (d, _) in got)
    _no_streamer_threads()


class DecodeFailed(Exception):
    pass


def test_a_decode_that_raises_ends_the_run(small):
    """A decode that raises ends the run with its exception; no worker
    process, decode thread or other streamer thread is left, and no block
    is decoded on the consumer in its place."""
    cfg, source, info, buckets = small
    calls = []

    def bad(block, bucket):
        calls.append(bucket)
        if bucket is buckets[2]:
            raise DecodeFailed("bad block")
        return block

    got, err, dt = _run(cfg, source, info, buckets, [CPU] * 2, seconds=60,
                        decode=bad)
    assert got is None and isinstance(err, DecodeFailed), err
    assert dt < 60 and len(calls) < 2 * len(buckets)
    _no_streamer_threads()


def test_closing_the_generator_joins_the_decode_threads(small):
    """Closing the generator while decodes are in flight joins every
    decode thread and ends every worker process."""
    cfg, source, info, buckets = small
    _, readback = trec.prepare_run(cfg, "cpu")
    before, n0 = misc.child_pids(), len(STARTED)

    def slow(block, bucket):
        time.sleep(0.5)
        return block

    gen = streamer_mod.stream_blocks(source, info, buckets, cfg, [CPU] * 2,
                                     readback, decode=slow)
    first, err = _bounded(lambda: next(gen))
    assert err is None and first[0] is buckets[0]
    _, err = _bounded(gen.close, seconds=30)
    assert err is None
    _no_streamer_threads()
    assert misc.child_pids() <= before
    assert not _alive(STARTED[n0:])


def test_step_profile_summarize():
    """utils/step_profile.summarize on a made-up trace of two steps: the
    wall, the sync wait on the step's thread, dispatch as the rest, the
    card's busy time as the union of its intervals, the syncs by the
    operator that made them."""
    from mlsgpu_tpu_torch.utils import step_profile

    def ev(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid}

    trace = {"traceEvents": [
        ev("user_annotation", "block_step", 0, 1000),
        ev("user_annotation", "block_step", 2000, 1000),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 5),
        ev("cuda_runtime", "cudaStreamSynchronize", 100, 300),
        ev("cuda_runtime", "cudaStreamSynchronize", 2100, 100),
        ev("cuda_runtime", "cudaEventSynchronize", 1500, 400),  # between
        ev("cuda_runtime", "cudaStreamSynchronize", 2500, 50, tid=2),
        ev("kernel", "k", 20, 100), ev("kernel", "k", 60, 100),
        ev("gpu_memcpy", "m", 2100, 200),
        ev("cpu_op", "aten::item", 90, 320),
        ev("cpu_op", "aten::_local_scalar_dense", 95, 310),
        ev("cpu_op", "aten::to", 2050, 200)]}
    s = step_profile.summarize(trace)
    assert s["steps"] == 2 and s["wall_ms"] == 1.0
    assert s["sync_ms"] == 0.2 and s["dispatch_ms"] == 0.8
    assert s["device_busy_ms"] == (140 + 200) / 2 / 1000
    assert s["launches"] == 0.5 and s["sync_calls"] == 1.0
    # each sync by the outermost operator that encloses it
    assert s["syncs_by_op"] == {"aten::item": [0.5, 0.15],
                                "aten::to": [0.5, 0.05]}
    assert step_profile.summarize({"traceEvents": []}) == {"steps": 0}


@pytest.mark.parametrize("entries", [1, 2])
def test_step_profiles_of_a_thread_and_of_processes(small, tmp_path,
                                                    monkeypatch, entries):
    """MLSGPU_PROFILE_STEPS: the one worker's thread, or each worker
    process, traces its steps from its third and writes the trace and its
    summary; the blocks are the run's without it."""
    import glob
    import json
    from mlsgpu_tpu_torch.utils import step_profile
    monkeypatch.setenv(step_profile.ENV, str(tmp_path))
    cfg, source, info, buckets = small
    got, err, _ = _run(cfg, source, info, buckets, [CPU] * entries)
    assert err is None, err
    assert [b for b, _ in got] == list(buckets)
    summaries = []
    for path in glob.glob(str(tmp_path / "*.json")):
        with open(path) as f:
            summaries.append(json.load(f))
        assert os.path.exists(path[:-5] + ".trace.json.gz")
    blocks = _worker_blocks()
    want = {f"device.{k}": min(step_profile.COUNT,
                               max(0, n - step_profile.FIRST))
            for k, n in blocks.items()}
    assert {s["worker"]: s["steps"] for s in summaries} == \
        {k: v for k, v in want.items() if v}
    for s in summaries:
        assert s["wall_ms"] >= s["dispatch_ms"] > 0
        assert (s["pid"] == os.getpid()) == (entries == 1)
