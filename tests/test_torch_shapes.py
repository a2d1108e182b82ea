"""Blocks above 256 corners an axis through the port's whole path, and the
shapes of each block that a run counts.

Tiled classification (the rule above `marching.TILED_ABOVE` corners an
axis, which `--levels 7` takes at 512^3) through a whole `reconstruct` on
the CPU, with the threshold lowered so that a small cloud takes it: the
mesh must be bit for bit the dense run's and correct by the benchmark's
plain reference (portbench/reference.py). The shape counters
(pipeline/workers.py::count_block) against the blocks' own counts, in a
thread and through worker processes; and the benchmark's byte functions
(portbench/shape_bytes.py) against the repository's bounds."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.ops import marching
from mlsgpu_tpu_torch.io.splat_set import SequenceSource
from mlsgpu_tpu_torch.pipeline import reconstruct as trec
from mlsgpu_tpu_torch.utils.statistics import get_registry
from portbench import reference, shape_bytes
from portbench.traffic.generator import make_cloud

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2147483725
#: The 512^3 cell's limits at the rehearsal's size.
with open(os.path.join(ROOT, "portbench", "workloads",
                       "sphere2m-l7.packed.json")) as _f:
    LIMITS = json.load(_f)["rehearsal_limits"]
SHAPES = ("march.cells", "march.candidateTiles", "march.tiledBlocks",
          "weld.unwelded", "weld.welded")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cloud():
    """6,000 splats of the benchmark's sphere scan, and the grid spacing
    the benchmark gives it (a third of the splat radius): 44 cells
    across, so 32^3-corner blocks (levels 3) cut it into many."""
    splats, sr = make_cloud(6000, SEED)
    return splats, sr / 3.0


def config(spacing, **kw) -> ReconstructConfig:
    base = dict(fit_grid=spacing, fit_smooth=1.0, fit_prune=0.02,
                fit_boundary_limit=1.0, levels=3, subsampling=3,
                max_device_splats=200000, tile_candidates=384,
                readback="packed", progress=False)
    base.update(kw)
    return ReconstructConfig(**base)


def run(cloud, tmp_path, name, **kw):
    """One whole reconstruction on the CPU: (the PLY's bytes, the run's
    statistics, each block's counts as the host decode got them)."""
    splats, spacing = cloud
    blocks = []
    decode = trec.block_result_to_input

    def recording(result, bucket):
        blocks.append(np.asarray(result.counts, np.int64).copy())
        return decode(result, bucket)

    get_registry().clear()
    out = str(tmp_path / f"{name}.ply")
    mp = pytest.MonkeyPatch()
    mp.setattr(trec, "block_result_to_input", recording)
    try:
        trec.reconstruct(SequenceSource(splats), config(spacing, **kw), out,
                         device="cpu")
    finally:
        mp.undo()
    with open(out, "rb") as f:
        data = f.read()
    return data, get_registry().to_dict(), np.array(blocks)


@pytest.fixture(scope="module")
def dense(cloud, tmp_path_factory):
    return run(cloud, tmp_path_factory.mktemp("dense"), "dense")


@pytest.fixture(scope="module")
def tiled(cloud, tmp_path_factory):
    """The same run with tiled classification: the threshold lowered below
    the blocks' 32 corners an axis."""
    mp = pytest.MonkeyPatch()
    mp.setattr(marching, "TILED_ABOVE", 16)
    try:
        return run(cloud, tmp_path_factory.mktemp("tiled"), "tiled")
    finally:
        mp.undo()


def total(stats, name):
    return stats[name]["total"] if name in stats else 0


def test_tiled_reconstruct_is_the_dense_one_and_correct(cloud, dense, tiled):
    data, stats, blocks = tiled
    assert data == dense[0]
    assert stats["bucket.count"]["total"] == len(blocks) > 1
    splats, spacing = cloud
    cfg = config(spacing)
    got = reference.judge(
        np.frombuffer(data, np.uint8), splats, spacing, cfg.fit_smooth,
        cfg.fit_prune, cfg.boundary_factor, SEED,
        dict(uniform=4096, face=1024, skeleton=256), cfg.micro_cells,
        torch.device("cpu"))
    assert got["vertices"] > 10000
    failing = {k: got[k] for k, limit in LIMITS.items()
               if k in got and not got[k] <= limit}
    assert not failing, (failing, LIMITS)


def test_tiled_blocks_are_counted_only_where_tiled(dense, tiled):
    _, dstats, dblocks = dense
    _, tstats, tblocks = tiled
    assert total(tstats, "march.tiledBlocks") == len(tblocks)
    assert total(tstats, "march.candidateTiles") == tblocks[:, 7].sum() > 0
    assert total(dstats, "march.tiledBlocks") == 0
    assert total(dstats, "march.candidateTiles") == 0
    assert "march.tiledBlocks" in dstats


@pytest.mark.parametrize("which", ["dense", "tiled"])
def test_shape_counters_are_the_blocks_sums(which, dense, tiled):
    _, stats, blocks = dense if which == "dense" else tiled
    n = stats["bucket.count"]["total"]
    assert total(stats, "march.cells") == blocks[:, 4].sum() > 0
    assert total(stats, "weld.unwelded") == blocks[:, 5].sum() > 0
    assert total(stats, "weld.welded") == blocks[:, 0].sum() > 0
    modes = {k: v["total"] for k, v in stats.items()
             if k.startswith("readback.index.")}
    # every block of this cloud welds under 2^16 vertices
    assert modes == {"readback.index.u16": n}
    assert total(stats, "readback.mode.packed") == n


def test_codes_readback_counts_no_weld(cloud, tmp_path):
    """The codes readback welds on the host: no weld or index counter."""
    from mlsgpu_tpu_torch import _native
    if not _native.available():
        pytest.skip("the native library did not build here")
    _, stats, blocks = run(cloud, tmp_path, "codes", readback="codes")
    assert total(stats, "march.cells") == blocks[:, 4].sum() > 0
    assert not [k for k in stats if k.startswith(("weld.unwelded",
                                                  "weld.welded",
                                                  "readback.index."))]


def test_shape_counters_reach_the_run_from_worker_processes(cloud, dense,
                                                            tmp_path):
    """Two queues on the CPU run each block in a worker process: the
    counters reach the run's registry, equal to the one-queue run's."""
    data, stats, _ = run(cloud, tmp_path, "queues", device_threads=2)
    assert stats["workers.spawned"]["total"] == 2
    _, one, _ = dense
    assert data == dense[0]
    for name in SHAPES + ("readback.index.u16", "readback.mode.packed"):
        assert total(stats, name) == total(one, name), name
    assert total(stats, "weld.welded") > 0


@pytest.mark.parametrize("b,classify", [(256, 67_436_544),
                                        (512, 539_492_352)])
def test_classify_bytes(b, classify):
    assert shape_bytes.classify_bytes(b) == classify
    assert classify == chip_smoke.marching_bound(
        "march_classify", b, 0, 0, 0, 0)["bytes"]
    assert shape_bytes.corners(4 * b ** 3) == b


@pytest.mark.parametrize("b,unwelded,welded", [(256, 776_917, 290_257),
                                               (512, 4_831_684, 2_133_246)])
def test_weld_bytes(b, unwelded, welded):
    want = chip_smoke.mesh_bound("weld", b, 0, unwelded, welded, 0, 0, 3)
    assert shape_bytes.weld_bytes(b, unwelded, welded) == want["bytes"]
    # linear in the counts: a job's totals give its blocks' sum
    assert shape_bytes.weld_bytes(b, 2 * unwelded, 2 * welded) == \
        2 * want["bytes"]


def test_weld_key_bytes_follow_the_port():
    from mlsgpu_tpu_torch.ops import mesh_cuda
    for b in (32, 77, 256, 300, 512, 1024, 2048, 8192):
        bits = mesh_cuda.key_bits(mesh_cuda.axis_bits(b))
        assert shape_bytes.weld_key_bytes(b) == mesh_cuda.sort_key_bytes(
            bits), b


def test_corners_refuses_a_field_of_no_cube():
    with pytest.raises(ValueError):
        shape_bytes.corners(4 * 256 ** 3 + 4)
