"""The seam passes' wrappers (ops/seam_cuda.py) and their kernels
(csrc/seam_moments.cu).

On the CPU: the wrappers take the plain passes for CPU tensors (bitwise
the same field, no launch counted) and raise for any other device; one
nvcc call builds both kernel sources for sm_90a.

On the card (`cuda` marker; skipped where there is none): each kernel
against its plain version, moments and hits value for value at the
default buffer and at buffers small enough to run many rounds, the passes'
fields equal, one launch counted per call, and the seam contract through
the kernels. The GPU hosts have no jax: run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_seam_*.py`.
"""

import os

import numpy as np
import pytest
import torch

from mlsgpu_tpu_torch.ops import block, mls, mls_cuda, seam_cuda
from mlsgpu_tpu_torch.pipeline.bucket import skeleton_points

# pytest puts tests/ on the path (no package: on the GPU hosts an installed
# `tests` package shadows the repo's)
from test_torch_seam_moments import (TPA, assert_equal_values, binned_block,
                                     bucket, sphere_cloud)


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
    before = seam_cuda.launch_counts()
    got = _passes(b, s, ln, origin, region, points, field, seam_cuda, fit, bf)
    ref = _passes(b, s, ln, origin, region, points, field, mls, fit, bf)
    assert seam_cuda.launch_counts() == before
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
        ["csrc", "mls_field.cu"], ["csrc", "seam_moments.cu"]]
    assert all(os.path.isfile(a) for a in sources)
    i = cmd.index("-gencode")
    assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[0] == "nvcc" and cmd[cmd.index("-o") + 1] == "lib.so"
    assert "-shared" in cmd


def test_launch_counts_add_up():
    saved = (mls_cuda.launches, seam_cuda.face_launches,
             seam_cuda.skeleton_launches)
    try:
        before = seam_cuda.launch_counts()
        seam_cuda.add_launch_counts([2, 3, 4])
        seam_cuda.count_launch("face")
        seam_cuda.count_launch("skeleton")
        after = seam_cuda.launch_counts()
        assert [b - a for a, b in zip(before, after)] == [2, 4, 5]
    finally:
        (mls_cuda.launches, seam_cuda.face_launches,
         seam_cuda.skeleton_launches) = saved


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
            s.to(dev), ln.to(dev), points.to(dev))


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
        before = seam_cuda.face_launches
        m, h = seam_cuda.face_moments(b.entry_data, b.entry_vals, s, ln,
                                      rows.to(torch.int32), buffer)
        torch.cuda.synchronize()
        assert seam_cuda.face_launches == before + 1
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
        before = seam_cuda.skeleton_launches
        m, h = seam_cuda.skeleton_moments(b.entry_data, b.entry_vals, s, ln,
                                          pts, tid, inside, buffer)
        torch.cuda.synchronize()
        assert seam_cuda.skeleton_launches == before + 1
        assert_equal_values(m.cpu().numpy(), ref_m.cpu().numpy())
        assert torch.equal(h, ref_h)


@pytest.mark.cuda
@pytest.mark.parametrize("fit,bf", [("sphere", 0.0), ("plane", 0.75)])
def test_kernel_passes_equal_the_plain_passes_on_card(cuda_device, tjunction,
                                                      fit, bf):
    splats, bks = tjunction
    for bk in bks:
        r = binned_block(splats, bk.cell_lo, bk.cell_hi, bk.skeleton)
        b, s, ln, points = _on(cuda_device, r[0], r[1], r[2], r[5])
        origin, region = r[3], r[4]
        field = mls_cuda.launch(b.entry_data, s, ln, origin, TPA, fit, bf)
        got = _passes(b, s, ln, origin, region, points, field, seam_cuda,
                      fit, bf)
        ref = _passes(b, s, ln, origin, region, points, field, mls, fit, bf)
        assert_equal_values(got.cpu().numpy(), ref.cpu().numpy())


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

    before = seam_cuda.launch_counts()
    fa, fc, fb = (field_of(bk) for bk in bks)
    assert [b - a for a, b in zip(before, seam_cuda.launch_counts())] == \
        [3, 3, 3]
    for pa, pb in ((fa[:, 16, 0:17], fb[:, 0, 0:17]),
                   (fc[:, 16, 0:16], fb[:, 0, 16:32]),
                   (fa[:, 0:17, 16], fc[:, 0:17, 0])):
        na = np.isnan(pa)
        np.testing.assert_array_equal(na, np.isnan(pb))
        assert (~na).sum() >= 20
        np.testing.assert_array_equal(pa[~na].view(np.uint32),
                                      pb[~na].view(np.uint32))
