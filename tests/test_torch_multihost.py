"""The port's parallel/multihost.py over LocalTransport threads, on the CPU:
its host functions against the JAX module's on the same inputs (exact), a
2-rank reconstruct_distributed against the port's single-process chunked
run (exact per-chunk counts) and the JAX package's reconstruct (per-chunk
counts within the larger of 1/500 and 16 vertices, 32 triangles, after the
bound of tests/test_torch_reconstruct.py: the two packages' float fields
are not bitwise equal), global pruning, per-rank
checkpoints resumed on 1, 2 and 3 ranks, progress aggregation, and the
watchdog cases of tests/test_watchdog.py on the port's PeerWatchdog."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from mlsgpu_tpu.io import splat_set as jsplat_set
from mlsgpu_tpu.parallel import multihost as jmh
from mlsgpu_tpu.pipeline import reconstruct as jrec
from mlsgpu_tpu.pipeline.mesher import OOCMesher as JMesher
from mlsgpu_tpu_torch.core.chunk import ChunkId
from mlsgpu_tpu_torch.io import ply
from mlsgpu_tpu_torch.io.splat_set import SequenceSource
from mlsgpu_tpu_torch.parallel import multihost as tmh
from mlsgpu_tpu_torch.pipeline import reconstruct as trec
from mlsgpu_tpu_torch.pipeline.bucket import Bucket
from mlsgpu_tpu_torch.pipeline.mesher import OOCMesher
from mlsgpu_tpu_torch.utils.manifold import check_manifold
from mlsgpu_tpu_torch.utils.statistics import get_registry

from tests import oracle
from tests.test_torch_reconstruct import CENTER, RADIUS, small_config

SPLIT = 100_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_ranks(size, fn, mod=tmh):
    """fn(transport) on `size` threaded ranks of `mod`'s LocalTransport;
    the per-rank results. A rank's exception releases its peers and is
    re-raised."""
    transports = mod.LocalTransport.make(size)
    results = [None] * size
    errors = []

    def runner(r):
        try:
            results[r] = fn(transports[r])
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
            transports[r]._shared["barrier"].abort()

    threads = [threading.Thread(target=runner, args=(r,))
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def sphere(n=20000, sr=0.25, seed=21):
    return oracle.sphere_cloud(CENTER, RADIUS, n, sr,
                               np.random.default_rng(seed))


def summary(files):
    """{chunk suffix: (vertices, triangles)}; every file manifold."""
    out = {}
    for f in files:
        v, t = ply.read_mesh(f)
        rep = check_manifold(v, t)
        assert rep.is_manifold, (f, rep.reason)
        out[os.path.basename(f).split("_", 1)[1]] = (len(v), len(t))
    return out


def distributed(tmp_path, name, size=2, source=None, **kw):
    """One reconstruct_distributed run on `size` ranks; the sorted files."""
    src = source or SequenceSource(sphere())

    def fn(tr):
        cfg = small_config(output_split_size=SPLIT, **kw)
        return tmh.reconstruct_distributed(src, cfg, str(tmp_path / name),
                                           tr, device="cpu")
    per_rank = run_ranks(size, fn)
    files = [f for fs in per_rank for f in fs]
    assert len(set(files)) == len(files), "ranks own disjoint chunks"
    return sorted(files)


@pytest.fixture(scope="module")
def single_files(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("single") / "single.ply")
    files = trec.reconstruct(SequenceSource(sphere()),
                             small_config(output_split_size=SPLIT), out,
                             device="cpu")
    assert len(files) > 1
    return files


@pytest.fixture(scope="module")
def direct_files(tmp_path_factory):
    return distributed(tmp_path_factory.mktemp("direct"), "direct.ply")


@pytest.mark.parametrize("total,size", [(10, 3), (7, 7), (5, 8), (0, 2),
                                        (10**12 + 7, 5)])
def test_partition_equals_jax(total, size):
    for r in range(size):
        assert tmh._partition(total, r, size) == jmh._partition(total, r, size)
    assert tmh._partition(total, size - 1, size)[1] == total


def test_assign_chunks_equals_jax():
    rng = np.random.default_rng(4)
    buckets = [Bucket(chunk_id=ChunkId(gen=i % 7, coords=(i % 7, i % 3, 0)),
                      cell_lo=np.zeros(3, np.int64),
                      cell_hi=np.ones(3, np.int64),
                      blob_ids=np.zeros(0, np.int64),
                      num_splats=int(rng.integers(1, 1000)))
               for i in range(40)]
    for size in (1, 2, 3, 5):
        owner = tmh.assign_chunks(buckets, size)
        assert owner == jmh.assign_chunks(buckets, size)
        assert set(owner.values()) <= set(range(size))


def test_checkpoint_shards_equals_jax(tmp_path):
    base = str(tmp_path / "ckpt")
    ranks = [0, 2, 10, 9999, 10000, 12345]
    for r in ranks:
        open(f"{base}.rank{r:04d}", "wb").close()
    open(base + ".rankX", "wb").close()  # not a shard
    shards = tmh._checkpoint_shards(base)
    assert shards == [f"{base}.rank{r:04d}" for r in sorted(ranks)]
    assert shards == jmh._checkpoint_shards(base)


def test_distributed_blobs_equals_jax():
    splats = sphere(5000)
    port = run_ranks(3, lambda tr: tmh.distributed_blobs(
        SequenceSource(splats), small_config(), tr))
    ref = run_ranks(3, lambda tr: jmh.distributed_blobs(
        jsplat_set.SequenceSource(splats), small_config(jax=True), tr),
        mod=jmh)
    for p, j in zip(port, ref):
        assert p.num_splats == j.num_splats == 5000
        assert p.num_nonfinite == j.num_nonfinite
        assert p.grid.extents == j.grid.extents
        np.testing.assert_array_equal(p.micro_lo, j.micro_lo)
        np.testing.assert_array_equal(p.micro_dims, j.micro_dims)
        for field in ("start", "count", "lo", "hi"):
            np.testing.assert_array_equal(getattr(p.blobs, field),
                                          getattr(j.blobs, field))


@pytest.mark.parametrize("scatter", ["dynamic", "static"])
def test_two_ranks_match_single_process(tmp_path, single_files, scatter):
    files = distributed(tmp_path, "dist.ply", scatter=scatter)
    assert summary(files) == summary(single_files)


def test_two_ranks_match_jax_package(tmp_path, direct_files):
    out = str(tmp_path / "jax.ply")
    jax_files = jrec.reconstruct(
        jsplat_set.SequenceSource(sphere()),
        small_config(jax=True, output_split_size=SPLIT), out)
    port, ref = summary(direct_files), summary(jax_files)
    # A chunk may exist on one side only when it is a sliver: the sphere's
    # pole lies on a cell plane, where the sign of a corner is float noise.
    for key in sorted(set(port) | set(ref)):
        (pv, pt), (nv, nt) = port.get(key, (0, 0)), ref.get(key, (0, 0))
        assert abs(pv - nv) <= max(nv // 500, 16), key
        assert abs(pt - nt) <= max(nt // 500, 32), key
    assert len(set(port) & set(ref)) >= 8


def test_global_pruning_drops_debris_keeps_sphere(tmp_path):
    """A component that spans both ranks' chunks is sized globally: neither
    rank prunes it, while small debris goes, whichever rank owns it."""
    rng = np.random.default_rng(33)
    main = oracle.sphere_cloud(CENTER, RADIUS, 20000, 0.25, rng)
    debris = oracle.sphere_cloud(CENTER + [7.0, 0, 0], 0.35, 600, 0.18, rng)
    files = distributed(
        tmp_path, "p.ply", fit_prune=0.1,
        source=SequenceSource(np.concatenate([main, debris])))
    verts = np.concatenate([ply.read_mesh(f)[0] for f in files])
    assert verts[:, 0].max() < CENTER[0] + RADIUS + 1.0
    r = np.linalg.norm(verts - CENTER, axis=1)
    assert abs(np.median(r) - RADIUS) < 0.08


@pytest.fixture
def checkpoint(tmp_path):
    """A 2-rank checkpoint of the sphere. Made anew for each test: writing
    from a checkpoint consumes its spill files."""
    d = tmp_path / "ckpt"
    d.mkdir()
    ckpt = str(d / "state.ckpt")
    src = SequenceSource(sphere())

    def fn(tr):
        cfg = small_config(output_split_size=SPLIT, checkpoint=ckpt)
        return tmh.reconstruct_distributed(src, cfg, str(d / "unused.ply"),
                                           tr, device="cpu")
    assert all(fs == [] for fs in run_ranks(2, fn))
    assert tmh._checkpoint_shards(ckpt) == [ckpt + ".rank0000",
                                            ckpt + ".rank0001"]
    return ckpt


@pytest.mark.parametrize("ranks", [1, 2, 3])
def test_resume_with_any_rank_count_equals_direct(tmp_path, checkpoint,
                                                  direct_files, ranks):
    def fn(tr):
        return tmh.resume_distributed(
            checkpoint, small_config(output_split_size=SPLIT),
            str(tmp_path / "resumed.ply"), tr)
    resumed = sorted(f for fs in run_ranks(ranks, fn) for f in fs)
    assert len(resumed) == len(direct_files)
    for df, rf in zip(direct_files, resumed):
        for a, b in zip(ply.read_mesh(df), ply.read_mesh(rf)):
            np.testing.assert_array_equal(a, b)


def test_global_pruned_roots_multi_equals_jax(checkpoint):
    """Both packages' prune exchange on the same two checkpoint shards, one
    rank holding both and two ranks holding one each."""
    shards = tmh._checkpoint_shards(checkpoint)
    for size in (1, 2):
        def port_fn(tr):
            mine = [OOCMesher.resume(f) for i, f in enumerate(shards)
                    if i % size == tr.rank]
            return tmh.global_pruned_roots_multi(mine, 0.3, tr)

        def jax_fn(tr):
            mine = [JMesher.resume(f) for i, f in enumerate(shards)
                    if i % size == tr.rank]
            return jmh.global_pruned_roots_multi(mine, 0.3, tr)
        port = run_ranks(size, port_fn)
        assert port == run_ranks(size, jax_fn, mod=jmh)
        # a threshold of 30% of the vertices prunes nothing of one sphere;
        # above 100% it would prune every clump
        assert all(not s for per_rank in port for s in per_rank)


def test_imbalance_recorded_on_rank_0(tmp_path):
    get_registry().clear()
    distributed(tmp_path, "imb.ply", size=3)
    imb = get_registry().variable("distributed.imbalance")
    # threaded ranks share one registry, which the statistics merge on
    # rank 0 then counts once per rank; the value is the same each time
    assert imb.n >= 1 and 1.0 <= imb.get_mean() < 3.0
    assert get_registry().counter("distributed.rankSplats").get() > 0


def test_progress_aggregates_on_rank_0():
    from mlsgpu_tpu_torch.utils.progress import ProgressDisplay

    def fn(tr):
        prog = tmh.DistributedProgress(tr, total=300, show=(tr.rank == 0),
                                       poll_interval=0.02)
        for _ in range(10):
            prog += 10
        tr.allgather(None)  # every rank has published
        prog.close()
        if tr.rank == 0:
            assert isinstance(prog._display, ProgressDisplay)
            return prog._display.current
        return None
    assert run_ranks(3, fn)[0] == 300


def test_local_counters():
    trs = tmh.LocalTransport.make(2)
    c0, c1 = trs[0].progress_counter("x"), trs[1].progress_counter("x")
    c0.add(5)
    c1.add(7)
    assert c0.read() == 12 and c1.read() == 12
    claims = [trs[r % 2].claim_counter("q").claim() for r in range(6)]
    assert claims == list(range(6))


# --- the watchdog (tests/test_watchdog.py on the port's class) -------------

class FakeKV:
    """Per-rank heartbeat counters with injectable failure."""

    def __init__(self, size):
        self.counts = [0] * size
        self.dead = set()        # ranks whose counter stops advancing
        self.unreadable = set()  # ranks whose reads raise (store gone)
        self.lock = threading.Lock()

    def beat(self, rank):
        with self.lock:
            if rank not in self.dead:
                self.counts[rank] += 1

    def read(self, rank):
        with self.lock:
            if rank in self.unreadable:
                raise RuntimeError("store unavailable")
            return self.counts[rank]


def make_watchdog(kv, rank, size, timeout, aborts, interval=0.05):
    return tmh.PeerWatchdog(rank, size, beat=lambda: kv.beat(rank),
                            read_peer=kv.read, interval=interval,
                            timeout=timeout,
                            abort=lambda peer, stale: aborts.append(
                                (peer, stale)))


def test_watchdog_returns_result_with_live_peers():
    kv, aborts = FakeKV(2), []
    dogs = [make_watchdog(kv, r, 2, 5.0, aborts) for r in (0, 1)]
    try:
        assert dogs[0].watch(lambda: (time.sleep(0.3), "ok")[1]) == "ok"
        assert aborts == []
    finally:
        for d in dogs:
            d.stop()


def test_watchdog_reraises_collective_exception():
    kv = FakeKV(2)
    dog = make_watchdog(kv, 0, 2, 5.0, [])

    def boom():
        raise ValueError("collective failed")
    try:
        with pytest.raises(ValueError, match="collective failed"):
            dog.watch(boom)
    finally:
        dog.stop()


@pytest.mark.parametrize("fault", ["dead", "unreadable"])
def test_watchdog_aborts_on_stale_peer_within_bound(fault):
    """A peer whose counter stops, or whose counter cannot be read (the
    store's host died), is declared dead within the timeout."""
    kv, aborts = FakeKV(2), []
    dogs = [make_watchdog(kv, r, 2, 0.3, aborts) for r in (0, 1)]
    try:
        getattr(kv, fault).add(1)
        hang = threading.Event()

        def abort_and_release(peer, stale):
            aborts.append((peer, stale))
            hang.set()
        dogs[0]._abort = abort_and_release
        t0 = time.monotonic()
        dogs[0].watch(lambda: hang.wait(10.0))
        assert aborts and aborts[0][0] == 1
        assert time.monotonic() - t0 < 5.0
    finally:
        for d in dogs:
            d.stop()


def test_watchdog_busy_peer_is_not_dead():
    kv, aborts = FakeKV(2), []
    dogs = [make_watchdog(kv, r, 2, 0.4, aborts) for r in (0, 1)]
    try:
        done = threading.Event()
        threading.Thread(
            target=lambda: (time.sleep(1.2), done.set())).start()
        assert dogs[0].watch(lambda: (done.wait(10.0), "late")[1]) == "late"
        assert aborts == []
    finally:
        for d in dogs:
            d.stop()


def test_watchdog_default_abort_exit_code_and_env_timeout(monkeypatch):
    monkeypatch.setenv("MLSGPU_HB_TIMEOUT", "7.5")
    dog = tmh.PeerWatchdog(0, 1, beat=lambda: None, read_peer=lambda r: 0)
    try:
        assert dog._timeout == 7.5
        assert tmh.PeerWatchdog.EXIT_CODE == jmh.PeerWatchdog.EXIT_CODE == 13
    finally:
        dog.stop()


def test_ranks_with_worker_processes_match_one_queue(tmp_path, direct_files):
    """Two ranks, each with two device threads (worker processes forked
    from the one worker server that both ranks of this process hold),
    write bit for bit the files of two ranks with one queue each; no
    process of the run is left."""
    from mlsgpu_tpu_torch.utils import misc
    before = misc.child_pids()
    files = distributed(tmp_path, "queues.ply", device_threads=2)
    assert misc.child_pids() <= before
    assert [os.path.basename(f) for f in files] == \
        [os.path.basename(f).replace("direct", "queues")
         for f in direct_files]
    for f, g in zip(files, direct_files):
        for a, b in zip(ply.read_mesh(f), ply.read_mesh(g)):
            np.testing.assert_array_equal(a, b)
    assert get_registry().counter("workers.spawned").get() >= 4
