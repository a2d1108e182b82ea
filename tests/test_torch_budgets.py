"""Host memory budgets in the port's streamer (mirrors
tests/test_pipeline.py:433-457): tight --mem-load-splats,
--mem-host-splats and --mem-mesh budgets throttle the pipeline, their
peaks (mem.loadQueue, mem.hostSplats, mem.meshWindow) are recorded and stay
within budget, and the output is unchanged, with one queue and with three.
Plus a stress test of the byte budget the loader thread and the device
workers share."""

import random
import sys
import threading

import numpy as np
import pytest
import torch

from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.io import ply
from mlsgpu_tpu_torch.io.splat_set import SequenceSource
from mlsgpu_tpu_torch.pipeline import blobs as blobs_mod
from mlsgpu_tpu_torch.pipeline import bucket
from mlsgpu_tpu_torch.pipeline import reconstruct as trec
from mlsgpu_tpu_torch.utils.statistics import Peak, get_registry

from tests import oracle

PEAKS = ("mem.loadQueue", "mem.hostSplats", "mem.meshWindow")
SPLAT_BYTES = 8 * 4 + 1     # host bytes of one splat: (8,) f32 + valid


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(splats, cfg, out):
    get_registry().clear()
    trec.reconstruct(SequenceSource(splats), cfg, out, device="cpu")
    stats = get_registry().to_dict()
    return ply.read_mesh(out), {k: stats[k]["peak"] for k in PEAKS}


def test_tight_memory_budgets_end_to_end(tmp_path):
    splats = oracle.sphere_cloud(np.zeros(3), 3.0, 12000, 0.3,
                                 np.random.default_rng(3))
    # max_device_splats bounds the buckets in both runs; the tight run's
    # bucket budget gives the same bound (mem_bucket_splats / 32), so the
    # decomposition, and with it the output, is the same.
    max_splats = 4000
    base = dict(fit_grid=0.1, fit_smooth=1.0, levels=4, subsampling=3,
                leaf_cells=8, max_device_splats=max_splats,
                tile_candidates=512, progress=False)
    (v1, t1), roomy = _run(splats, ReconstructConfig(**base),
                           str(tmp_path / "roomy.ply"))
    assert all(roomy[k] > 0 for k in PEAKS), roomy

    # Splat budgets of about one block (the largest block's bytes, and at
    # least the bucket budget, which must not exceed them) hold the loader
    # to about one block at a time.
    info = blobs_mod.compute_blobs(SequenceSource(splats), 0.1, 8)
    cfg = ReconstructConfig(**base)
    maxn = max(b.num_splats for b in bucket.make_buckets(
        info, cfg.device_block_cells, cfg.micro_cells, max_splats=max_splats))
    block = max(maxn * SPLAT_BYTES, 32 * max_splats)
    # A mesh budget of exactly the largest image: every single image fits
    # it and no two of the largest do. (An image is held from the start of
    # its copy until its block is yielded, so how many the roomy run holds
    # at its peak depends on how fast the mesher takes them: one at least.)
    from mlsgpu_tpu_torch.pipeline.streamer import stream_blocks
    devices, readback = trec.prepare_run(cfg, "cpu")
    mesh = max(r.packed.nbytes for _, r in stream_blocks(
        SequenceSource(splats), info, bucket.make_buckets(
            info, cfg.device_block_cells, cfg.micro_cells,
            max_splats=max_splats), cfg, devices, readback))
    assert 0 < mesh <= roomy["mem.meshWindow"]
    tight = ReconstructConfig(mem_bucket_splats=32 * max_splats,
                              mem_load_splats=block, mem_host_splats=block,
                              mem_mesh=mesh, **base)
    assert roomy["mem.hostSplats"] > block and roomy["mem.loadQueue"] > 0
    (v2, t2), peaks = _run(splats, tight, str(tmp_path / "tight.ply"))
    assert 0 < peaks["mem.loadQueue"] <= block
    assert 0 < peaks["mem.hostSplats"] <= block < roomy["mem.hostSplats"]
    assert 0 < peaks["mem.meshWindow"] <= mesh
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(t1, t2)


def test_tight_memory_budgets_with_three_queues(tmp_path):
    """The same budgets over three queues (--device-threads 3): the splat
    budgets hold as they are the loader's, the images of all workers
    together stay within --mem-mesh plus one image (the oldest block not
    yet yielded is always admitted), and the output is the roomy
    one-queue run's."""
    splats = oracle.sphere_cloud(np.zeros(3), 3.0, 6000, 0.4,
                                 np.random.default_rng(3))
    max_splats = 2000
    base = dict(fit_grid=0.1, fit_smooth=1.0, levels=3, subsampling=3,
                leaf_cells=8, max_device_splats=max_splats,
                tile_candidates=512, progress=False)
    (v1, t1), roomy = _run(splats, ReconstructConfig(**base),
                           str(tmp_path / "roomy.ply"))
    block = 32 * max_splats
    mesh = roomy["mem.meshWindow"] // 2
    tight = ReconstructConfig(mem_bucket_splats=32 * max_splats,
                              mem_load_splats=block, mem_host_splats=block,
                              mem_mesh=mesh, device_threads=3, **base)
    (v2, t2), peaks = _run(splats, tight, str(tmp_path / "tight.ply"))
    assert 0 < peaks["mem.loadQueue"] <= block
    assert 0 < peaks["mem.hostSplats"] <= block
    # one image is at most the roomy run's peak, which held two or more
    assert 0 < peaks["mem.meshWindow"] <= mesh + roomy["mem.meshWindow"]
    assert get_registry().counter("device.blocks.0.2").get() > 0
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(t1, t2)


def test_byte_budget_stress():
    """Threads (more than cores) acquire and release random amounts under
    a shortened switch interval: the bytes held never exceed the budget
    unless one item alone does, the peak says the same, and all is
    released at the end."""
    from mlsgpu_tpu_torch.pipeline.streamer import ByteBudget
    budget = 100
    peak = Peak("test.budget")
    cancel = threading.Event()
    bb = ByteBudget(budget, peak, cancel)
    lock = threading.Lock()
    held_items: list = []
    bad: list = []

    def worker(seed):
        rng = random.Random(seed)
        for _ in range(300):
            n = rng.choice((1, 7, 30, 60, 99, 150))
            assert bb.acquire(n)
            with lock:
                held_items.append(n)
                total = sum(held_items)
                if total > budget and len(held_items) > 1:
                    bad.append(list(held_items))
            with lock:
                held_items.remove(n)
            bb.release(n)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad, bad[:3]
    assert bb.held == 0 and peak.get() == 0
    assert budget >= peak.get_max() or peak.get_max() == 150


def test_byte_budget_cancel():
    from mlsgpu_tpu_torch.pipeline.streamer import ByteBudget
    cancel = threading.Event()
    bb = ByteBudget(10, Peak("test.cancel"), cancel)
    assert bb.acquire(8)
    got = []
    t = threading.Thread(target=lambda: got.append(bb.acquire(8)))
    t.start()
    cancel.set()
    t.join(timeout=10)
    assert not t.is_alive() and got == [False] and bb.held == 8
