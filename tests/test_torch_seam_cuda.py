"""The seam passes' wrappers (ops/seam_cuda.py) and their kernels
(csrc/seam_moments.cu).

On the CPU: the wrappers take the plain passes for CPU tensors (bitwise
the same field, no launch counted) and raise for any other device; one
nvcc call builds both kernel sources for sm_90a.

On the card (`cuda` marker; skipped where there is none): torch's CUDA
division, reciprocal, square root and scalar products round as IEEE
float32 does (the kernels' fit relies on it); each kernel's moments mode
against the plain moments, value for value, at the default buffer and at
buffers small enough to run many windows; each pass's field bit for bit
the plain pass's, for both fits and both buffers, in one launch; face
passes at full size on two streams at once; and the seam contract through
the kernels. The GPU hosts have no jax: run them
there with `python -m pytest --noconftest -m cuda tests/test_torch_seam_*.py`.
"""

import os
import time

import numpy as np
import pytest
import torch

from mlsgpu_tpu_torch.convert import block_inputs_from_numpy
from mlsgpu_tpu_torch.ops import (binning, block, launches, mls, mls_cuda,
                                  seam_cuda)
from mlsgpu_tpu_torch.pipeline.bucket import skeleton_points

# pytest puts tests/ on the path (no package: on the GPU hosts an installed
# `tests` package shadows the repo's)
from test_torch_seam_epilogue import assert_same_bits
from test_torch_seam_moments import (FACE_BLOCKS, TPA, assert_equal_values,
                                     binned_block, bucket, sphere_cloud)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tjunction():
    """The T-junction blocks (tests/test_torch_faces.py's) with their
    skeleton points; the last block's are the junction's."""
    splats = sphere_cloud([12.0, 12.0, 16.0], 7.0, 9000, 3)
    bks = [bucket((0, 0, 0), (16, 16, 31)), bucket((16, 0, 0), (31, 16, 31)),
           bucket((0, 16, 0), (31, 31, 31))]
    skeleton_points(bks)
    return splats, bks


def _passes(b, s, ln, origin, region, points, field, seam, fit="sphere",
            bf=0.0, **kw):
    f = seam.canonical_face_field(field.clone(), b.entry_data, b.entry_vals,
                                  s, ln, origin, region, TPA, fit, bf, **kw)
    return seam.skeleton_point_field(f, b.entry_data, b.entry_vals, s, ln,
                                     origin, points, TPA, fit, bf, **kw)


# --- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("fit,bf", [("sphere", 0.0), ("plane", 0.75)])
def test_wrappers_take_the_plain_passes_on_cpu(tjunction, fit, bf):
    splats, bks = tjunction
    bk = bks[2]
    b, s, ln, origin, region, points = binned_block(splats, bk.cell_lo,
                                                    bk.cell_hi, bk.skeleton)
    field = mls.eval_field(b.entry_data, s, ln, origin, TPA, fit, bf)
    before = launches.counts()
    got = _passes(b, s, ln, origin, region, points, field, seam_cuda, fit, bf)
    ref = _passes(b, s, ln, origin, region, points, field, mls, fit, bf)
    assert launches.counts() == before
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.numpy().view(np.uint32))
    assert (got.numpy().view(np.uint32)
            != field.numpy().view(np.uint32)).sum() > 50


def test_wrappers_raise_for_another_device(tjunction):
    splats, bks = tjunction
    bk = bks[2]
    b, s, ln, origin, region, points = binned_block(splats, bk.cell_lo,
                                                    bk.cell_hi, bk.skeleton)
    meta = [t.to("meta") for t in (b.entry_data, b.entry_vals, s, ln)]
    field = torch.empty((32, 32, 32), device="meta")
    with pytest.raises(ValueError, match="meta"):
        seam_cuda.canonical_face_field(field, *meta, origin, region, TPA,
                                       "sphere", 0.0)
    with pytest.raises(ValueError, match="meta"):
        seam_cuda.skeleton_point_field(field, *meta, origin,
                                       points.to("meta"), TPA, "sphere", 0.0)


def test_one_nvcc_call_builds_both_sources_for_sm_90a():
    cmd = mls_cuda.build_command(["nvcc"], "lib.so")
    sources = [a for a in cmd if a.endswith(".cu")]
    assert [a.replace("\\", "/").rsplit("/", 2)[-2:] for a in sources] == [
        ["csrc", "mls_field.cu"], ["csrc", "seam_moments.cu"],
        ["csrc", "binning.cu"], ["csrc", "marching.cu"], ["csrc", "mesh.cu"]]
    assert all(os.path.isfile(a) for a in sources)
    i = cmd.index("-gencode")
    assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[0] == "nvcc" and cmd[cmd.index("-o") + 1] == "lib.so"
    assert "-shared" in cmd


def _since(before, *names):
    """The launches of the kernels `names` since `before`."""
    now = launches.since(before)
    return [now[k] for k in names]


SEAM = ("mls_field", "seam_face", "seam_skeleton")


def test_launch_counts_add_up():
    saved = launches.counts()
    try:
        launches.add({"mls_field": 2, "seam_face": 3, "seam_skeleton": 4})
        launches.count("seam_face")
        launches.count("seam_skeleton")
        assert _since(saved, *SEAM) == [2, 4, 5]
        with pytest.raises(KeyError):
            launches.count("face")
    finally:
        launches.reset()
        launches.add(saved)


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the seam kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _on(dev, b, s, ln, points):
    return (b._replace(entry_data=b.entry_data.to(dev),
                       entry_keys=b.entry_keys.to(dev),
                       entry_vals=b.entry_vals.to(dev)),
            s.to(dev), ln.to(dev), None if points is None else points.to(dev))


@pytest.mark.cuda
def test_torch_rounds_as_the_kernel_fit_does_on_card(cuda_device):
    """What the plain fit's torch ops do on the card: 1.0 / x, x / y,
    sqrt, (4 * FLT_EPSILON) * hits * |x| and a float scalar times a tensor
    are IEEE float32, correctly rounded (numpy's on the CPU)."""
    rng = np.random.default_rng(5)
    f32 = np.float32
    with np.errstate(all="ignore"):
        x = (rng.normal(size=100_000) * np.exp2(rng.integers(-30, 30, 100_000))
             ).astype(f32)
        y = (rng.normal(size=100_000) * np.exp2(rng.integers(-30, 30, 100_000))
             ).astype(f32)
        h = rng.integers(0, 200, 100_000).astype(np.int32)
        tx, ty, th = (torch.as_tensor(v, device=cuda_device) for v in (x, y, h))
        pairs = [
            (1.0 / tx, f32(1.0) / x),
            (tx / ty, x / y),
            (torch.sqrt(torch.abs(tx)), np.sqrt(np.abs(x))),
            ((4 * 1.1920929e-07) * th * torch.abs(ty),
             (f32(4 * 1.1920929e-07) * h.astype(f32)) * np.abs(y)),
            (0.75 * tx, f32(0.75) * x),
            (tx - 2.0 * ty + tx * ty, (x - f32(2.0) * y) + x * y),
        ]
    for got, ref in pairs:
        assert_same_bits(got.cpu().numpy(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("buffer", [None, 4, 32])
def test_face_kernel_matches_plain_on_card(cuda_device, tjunction, buffer):
    splats, bks = tjunction
    for bk in bks:
        r = binned_block(splats, bk.cell_lo, bk.cell_hi, bk.skeleton)
        b, s, ln, _ = _on(cuda_device, r[0], r[1], r[2], r[5])
        rows = torch.as_tensor(mls.face_rows(r[3], r[4], TPA),
                               device=cuda_device)
        ref_m, ref_h = mls.face_moments(b.entry_data, b.entry_vals, s, ln,
                                        rows)
        before = launches.counts()
        m, h = seam_cuda.face_moments(b.entry_data, b.entry_vals, s, ln,
                                      r[3], r[4], TPA, buffer)
        torch.cuda.synchronize()
        assert _since(before, "seam_face") == [1]
        assert_equal_values(m.cpu().numpy(), ref_m.cpu().numpy())
        assert torch.equal(h, ref_h) and int((h > 0).sum()) > 20


@pytest.mark.cuda
@pytest.mark.parametrize("buffer", [None, 4])
def test_skeleton_kernel_matches_plain_on_card(cuda_device, tjunction,
                                               buffer):
    splats, bks = tjunction
    for bk in bks:
        r = binned_block(splats, bk.cell_lo, bk.cell_hi, bk.skeleton)
        b, s, ln, points = _on(cuda_device, r[0], r[1], r[2], r[5])
        origin = tuple(int(v) for v in bk.cell_lo)
        pts, _, tid, inside = mls.skeleton_points(points, origin, TPA, 32)
        ref_m, ref_h = mls.skeleton_moments(b.entry_data, b.entry_vals, s, ln,
                                            pts, tid, inside)
        before = launches.counts()
        m, h = seam_cuda.skeleton_moments(b.entry_data, b.entry_vals, s, ln,
                                          origin, points, TPA, buffer)
        torch.cuda.synchronize()
        assert _since(before, "seam_skeleton") == [1]
        assert_equal_values(m.cpu().numpy(), ref_m.cpu().numpy())
        assert torch.equal(h, ref_h)


@pytest.mark.cuda
@pytest.mark.parametrize("buffer", [None, 4])
@pytest.mark.parametrize("fit,bf", [("sphere", 0.0), ("plane", 0.75)])
def test_kernel_passes_equal_the_plain_passes_on_card(cuda_device, tjunction,
                                                      fit, bf, buffer):
    """The T-junction blocks (with their skeleton points) and the face test
    blocks (aligned, and straddling the in-plane edge): each pass one
    launch, its field the plain pass's bit for bit."""
    splats, bks = tjunction
    cloud = sphere_cloud([28.0, 14.0, 14.0], 9.0, 6000, 42)
    blocks = [(splats, bk.cell_lo, bk.cell_hi, bk.skeleton) for bk in bks]
    blocks += [(cloud, lo, hi, None) for lo, hi in FACE_BLOCKS.values()]
    for cl, lo, hi, skel in blocks:
        r = binned_block(cl, lo, hi, skel)
        b, s, ln = _on(cuda_device, r[0], r[1], r[2], r[5])[:3]
        origin, region = r[3], r[4]
        points = None if skel is None else r[5].to(cuda_device)
        field = mls_cuda.launch(b.entry_data, s, ln, origin, TPA, fit, bf)
        before = launches.counts()
        got = _passes(b, s, ln, origin, region, points, field, seam_cuda,
                      fit, bf, buffer=buffer)
        assert _since(before, *SEAM) == [0, 1, int(points is not None)]
        ref = _passes(b, s, ln, origin, region, points, field, mls, fit, bf)
        assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_t_junction_bitwise_through_the_kernels_on_card(cuda_device,
                                                        tjunction):
    """tests/test_torch_faces.py's T-junction case on the card: every
    shared corner bitwise equal across the three blocks."""
    splats, bks = tjunction

    def field_of(bk):
        f, _ = block.block_field(
            torch.as_tensor(splats, device=cuda_device),
            torch.ones(len(splats), dtype=torch.bool, device=cuda_device),
            tuple(int(v) for v in bk.cell_hi - bk.cell_lo),
            tuple(int(v) for v in bk.cell_lo), 0.0,
            torch.as_tensor(bk.skeleton, device=cuda_device), levels=3,
            subsampling=3)
        return f.cpu().numpy()

    before = launches.counts()
    fa, fc, fb = (field_of(bk) for bk in bks)
    assert _since(before, *SEAM) == [3, 3, 3]
    for pa, pb in ((fa[:, 16, 0:17], fb[:, 0, 0:17]),
                   (fc[:, 16, 0:16], fb[:, 0, 16:32]),
                   (fa[:, 0:17, 16], fc[:, 0:17, 0])):
        na = np.isnan(pa)
        np.testing.assert_array_equal(na, np.isnan(pb))
        assert (~na).sum() >= 20
        np.testing.assert_array_equal(pa[~na].view(np.uint32),
                                      pb[~na].view(np.uint32))


@pytest.mark.cuda
def test_face_passes_on_two_streams_at_full_size_on_card(cuda_device):
    """Two face passes at the main path's size (256^3 corners, 32 tiles an
    axis) at once on two streams of one card, four rounds interleaved:
    both finish (no CTA of a pass waits on another, so passes sharing the
    card in any proportion make progress) and every field is the plain
    pass's bit for bit."""
    dev, levels, sub, tpa = cuda_device, 6, 3, 32
    splats = sphere_cloud([200.0, 200.0, 200.0], 100.0, 200_000, 11, 2.0)
    args = block_inputs_from_numpy(splats, np.ones(len(splats), bool),
                                   (255, 255, 255), (0, 0, 0), device=dev)
    origin, region = args["cell_origin"], args["region_cells"]
    b = binning.bin_splats(args["splats"], args["valid"], origin, sub,
                           levels + sub - 1)
    s, ln = binning.tile_segments(b.entry_keys, sub, levels + sub - 1, tpa)
    field = mls_cuda.launch(b.entry_data, s, ln, origin, tpa, "sphere", 0.0)
    face = (b.entry_data, b.entry_vals, s, ln, origin, region, tpa, "sphere",
            0.0)
    ref = mls.canonical_face_field(field.clone(), *face)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    outs = [[field.clone() for _ in range(4)] for _ in streams]
    torch.cuda.synchronize(dev)
    for i in range(4):
        for st, fs in zip(streams, outs):
            with torch.cuda.stream(st):
                seam_cuda.canonical_face_field(fs[i], *face)
    done = [torch.cuda.Event() for _ in streams]
    for ev, st in zip(done, streams):
        ev.record(st)
    deadline = time.monotonic() + 60.0
    while not all(ev.query() for ev in done):
        assert time.monotonic() < deadline, "face passes did not finish"
        time.sleep(0.001)
    rows = mls.face_rows(origin, region, tpa)
    _, hits = mls.face_moments(b.entry_data, b.entry_vals, s, ln,
                               torch.as_tensor(rows, device=dev))
    assert int((hits.sum(1) > 0).sum()) > 100   # many occupied rows
    for fs in outs:
        for f in fs:
            assert_same_bits(f.cpu().numpy(), ref.cpu().numpy())
