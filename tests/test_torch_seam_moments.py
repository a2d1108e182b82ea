"""The seam kernels' arithmetic, held on the CPU (csrc/seam_moments.cu has
no CPU mode): what the face and skeleton kernels compute, written out in
numpy in the kernels' own order, against the plain versions
(ops/mls.py::face_moments, ::skeleton_moments), value for value.

- The sum each corner thread builds (a binary-counter stack of partial
  sums over its terms in bit-reversed order; with more terms than it
  holds, over residue classes of ranks, then over the classes) equals
  `mls._tree_sum` over the terms padded with zeros to a power of two, bit
  for bit, for every count of nonzero f32 terms from 1 to 300, at two
  widths, holding 4 or 128 terms.
- An emulation of a kernel row (the covering tiles' segments, the filter,
  the candidates sorted by splat identity with repeats skipped, each
  corner's sum of its nonzero-weight terms as above) gives the plain
  version's moments and hits value for value, and through the shared fit
  the plain pass's field, on the face test blocks (aligned and
  straddling) for both fits and on the T-junction skeleton case.
- The property the kernels' rounds rest on: a splat sits at most once in
  a tile's chain of level segments (so at most 4 times in a face row's
  candidates), while a segment does not list its splats in stream order
  (so the kernel sorts each round's candidates rather than merging the
  segments).

Fixtures are built inline (no jax, no tests.oracle), as in
tests/test_torch_seam_cuda.py.
"""

import numpy as np
import pytest
import torch

from mlsgpu_tpu_torch.convert import block_inputs_from_numpy
from mlsgpu_tpu_torch.models.common import RADIUS_CUTOFF
from mlsgpu_tpu_torch.ops import binning, mls
from mlsgpu_tpu_torch.pipeline.bucket import Bucket, skeleton_points

LEVELS, SUB = 3, 3
B = 1 << (LEVELS + SUB - 1)   # 32 corners per axis
TPA = B // 8
F32 = np.float32
CUT = F32(RADIUS_CUTOFF)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sphere_cloud(center, radius, n, seed, splat_radius=1.2):
    """Splats on a sphere with outward normals (tests/oracle.py's)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    out = np.empty((n, 8), np.float32)
    out[:, 0:3] = np.asarray(center, np.float64) + radius * v
    out[:, 3] = splat_radius
    out[:, 4:7] = v
    out[:, 7] = 1.0 / splat_radius ** 2
    return out


def bucket(lo, hi):
    return Bucket(chunk_id=None, cell_lo=np.array(lo, np.int64),
                  cell_hi=np.array(hi, np.int64),
                  blob_ids=np.empty(0, np.int64), num_splats=1)


def binned_block(splats, lo, hi, points=None):
    """(binned entries, starts, lens, origin, region, points) of a block."""
    args = block_inputs_from_numpy(splats, np.ones(len(splats), bool),
                                   np.subtract(hi, lo), lo, points)
    b = binning.bin_splats(args["splats"], args["valid"],
                           args["cell_origin"], SUB, LEVELS + SUB - 1)
    s, ln = binning.tile_segments(b.entry_keys, SUB, LEVELS + SUB - 1, TPA)
    return b, s, ln, args["cell_origin"], args["region_cells"], args["points"]


# --- the tree sum, as the kernels build it ------------------------------------

def _reverse(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def stack_sum(leaves):
    """A binary-counter stack of partial sums over `leaves` (9-vectors,
    a power of two of them): left + right while the two top blocks have
    equal size, folded from the top at the end (csrc/seam_moments.cu
    TreeSum)."""
    stk, count = [], 0
    for leaf in leaves:
        t, c = leaf.astype(F32), count
        while c & 1:
            t = stk.pop() + t
            c >>= 1
        stk.append(t)
        count += 1
    acc = stk[-1]
    for part in reversed(stk[:-1]):
        acc = part + acc
    return acc


def halves(terms, bits):
    """The stack over 2^bits leaves in bit-reversed order: leaf j holds
    term rev(j) (zero beyond the terms)."""
    zero = np.zeros(9, F32)
    return stack_sum([terms[_reverse(j, bits)]
                      if _reverse(j, bits) < len(terms) else zero
                      for j in range(1 << bits)])


def kernel_sum(terms, held):
    """A corner's sum of its terms (in stream order) as the kernels build
    it, holding `held` (a power of two) terms at once: one list in
    bit-reversed order, or 2^c residue classes of ranks, each summed so,
    then the class sums over the classes in bit-reversed order."""
    n = len(terms)
    bits = (n - 1).bit_length() if n > 1 else 0
    if n <= held:
        return halves(terms, bits)
    cbits = bits - (held.bit_length() - 1)
    return stack_sum([halves(terms[_reverse(p, cbits)::1 << cbits],
                             held.bit_length() - 1)
                      for p in range(1 << cbits)])


@pytest.mark.parametrize("held", [4, 128])
def test_kernel_sum_is_the_padded_pairwise_tree(held):
    rng = np.random.default_rng(0)
    for n in range(1, 301):
        mags = np.exp2(rng.integers(-20, 20, size=(n, 9))).astype(F32)
        terms = (rng.uniform(0.5, 1.0, size=(n, 9)).astype(F32) * mags
                 * rng.choice([-1, 1], size=(n, 9)).astype(F32))
        got = kernel_sum(terms, held)
        width = mls._pow2(n)
        for w in (width, 2 * width):
            padded = np.zeros((w, 9), F32)
            padded[:n] = terms
            ref = mls._tree_sum(torch.as_tensor(padded), dim=0).numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          ref.view(np.uint32), err_msg=str(n))


# --- one kernel row, emulated -------------------------------------------------

def _dot3(a0, a1, a2, b0, b1, b2):
    return (a0 * b0 + a1 * b1) + a2 * b2


def _row_sums(data, ids, frame, corners, held):
    """The kernel's consumption of one row's candidates (`data` (K, 8),
    `ids` (K,) the filtered candidates in any order, repeats allowed),
    corners (C, 3) in the row's frame (3,): sort by identity, skip
    repeats, each corner's nonzero-weight terms summed by kernel_sum.
    Returns (moments (C, 9), hits (C,))."""
    order = np.argsort(ids, kind="stable")
    ids, data = ids[order], data[order]
    keep = np.ones(len(ids), bool)
    keep[1:] = ids[1:] != ids[:-1]
    data = data[keep]
    x0, x1, x2 = (data[:, a] - frame[a] for a in range(3))
    n0, n1, n2 = data[:, 4], data[:, 5], data[:, 6]
    feat = np.stack([x0, x1, x2, _dot3(x0, x1, x2, x0, x1, x2), n0, n1, n2,
                     _dot3(n0, n1, n2, x0, x1, x2)], axis=1)
    cx, cy, cz = (corners[:, a][:, None] for a in range(3))
    cc = _dot3(cx, cy, cz, cx, cy, cz)
    dotcx = (cx * x0[None] + cy * x1[None]) + cz * x2[None]       # (C, K)
    d = ((feat[None, :, 3] - F32(2.0) * dotcx) + cc) * data[None, :, 3]
    hit = d < CUT
    w = F32(1.0) - d
    w = w * w
    w = w * w
    w = np.where(hit, w * data[None, :, 7], F32(0.0))
    moments = np.zeros((len(corners), 9), F32)
    for c in np.nonzero((w != 0).any(axis=1))[0]:
        pos = ~(w[c] == 0)
        terms = np.concatenate([w[c, pos][:, None],
                                feat[pos] * w[c, pos][:, None]], axis=1)
        moments[c] = kernel_sum(terms, held)
    return moments, hit.sum(axis=1).astype(np.int32)


def _segments(starts, lens, tiles):
    """Entry indices of the level segments of the distinct `tiles`."""
    seen, out = [], []
    for t in tiles:
        if t in seen:
            continue
        seen.append(t)
        for st, ln in zip(starts[t], lens[t]):
            out.append(np.arange(st, st + ln))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def emulate_face(entry_data, entry_vals, starts, lens, rows, held):
    """The face kernel over every patch row, in numpy."""
    frames, corners = (t.numpy() for t in mls.face_frames(torch.as_tensor(rows)))
    moments = np.zeros((len(rows), 64, 9), F32)
    hits = np.zeros((len(rows), 64), np.int32)
    for r, row in enumerate(rows):
        cand = _segments(starts, lens, list(row[mls.ROW_TILES:]))
        if not len(cand):
            continue
        p = entry_data[cand]
        aa = int(row[mls.ROW_AXIS])
        b0 = F32(row[mls.ROW_BASE_B])
        c0 = F32(row[mls.ROW_BASE_C])
        da = p[:, aa] - F32(row[mls.ROW_PLANE])
        pb, pc = p[:, (aa + 1) % 3], p[:, (aa + 2) % 3]
        db = np.maximum(np.maximum(b0 - pb, pb - (b0 + F32(7.0))), F32(0.0))
        dc = np.maximum(np.maximum(c0 - pc, pc - (c0 + F32(7.0))), F32(0.0))
        rect2 = (da * da + db * db) + dc * dc
        ok = rect2 * p[:, 3] < CUT
        if ok.any():
            moments[r], hits[r] = _row_sums(p[ok], entry_vals[cand][ok],
                                            frames[r], corners[r], held)
    return moments, hits


def emulate_skeleton(entry_data, entry_vals, starts, lens, pts, tid, inside,
                     held):
    """The skeleton kernel over every point, in numpy."""
    moments = np.zeros((len(pts), 1, 9), F32)
    hits = np.zeros((len(pts), 1), np.int32)
    for i, (p3, t, ins) in enumerate(zip(pts, tid, inside)):
        if not ins:
            continue
        cand = _segments(starts, lens, [int(t)])
        p = entry_data[cand]
        dx, dy, dz = (p[:, a] - F32(p3[a]) for a in range(3))
        ok = _dot3(dx, dy, dz, dx, dy, dz) * p[:, 3] < CUT
        if ok.any():
            base = (p3 // 8) * 8
            moments[i], hits[i] = _row_sums(
                p[ok], entry_vals[cand][ok], base.astype(F32),
                (p3 - base).astype(F32)[None, :], held)
    return moments, hits


def assert_equal_values(got, ref):
    """Value for value: == (signed zeros equal) or both NaN."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    same = (got == ref) | (np.isnan(got) & np.isnan(ref))
    assert same.all(), f"{int((~same).sum())} of {same.size} differ"


FACE_BLOCKS = {"aligned": ((0, 0, 0), (28, 31, 31)),
               "straddling": ((0, 3, 0), (28, 34, 31))}


@pytest.fixture(scope="module")
def face_cloud():
    return sphere_cloud([28.0, 14.0, 14.0], 9.0, 6000, 42)


# `held`: the kernels' list (128), and 4, as a small buffer makes it, so
# that corners with more terms than that run the residue classes
@pytest.mark.parametrize("block_name", sorted(FACE_BLOCKS))
@pytest.mark.parametrize("fit,bf,held", [("sphere", 0.0, 128),
                                         ("plane", 0.75, 4)])
def test_face_kernel_emulation_matches_plain(face_cloud, block_name, fit,
                                             bf, held):
    lo, hi = FACE_BLOCKS[block_name]
    b, s, ln, origin, region, _ = binned_block(face_cloud, lo, hi)
    rows = mls.face_rows(origin, region, TPA)
    rows_t = torch.as_tensor(rows)
    ref_m, ref_h = mls.face_moments(b.entry_data, b.entry_vals, s, ln, rows_t)
    m, h = emulate_face(b.entry_data.numpy(), b.entry_vals.numpy(),
                        s.numpy(), ln.numpy(), rows, held)
    assert (h > 0).sum() > 100           # the planes really have candidates
    assert_equal_values(m, ref_m.numpy())
    np.testing.assert_array_equal(h, ref_h.numpy())
    # through the shared fit and write: the plain pass's field
    field = mls.eval_field(b.entry_data, s, ln, origin, TPA, fit, bf)
    ref = mls.canonical_face_field(field.clone(), b.entry_data, b.entry_vals,
                                   s, ln, origin, region, TPA, fit, bf)
    got = mls.fit_faces(field.clone(), torch.as_tensor(m),
                        torch.as_tensor(h), rows_t, origin, region, TPA, fit,
                        bf)
    assert_equal_values(got.numpy(), ref.numpy())


@pytest.mark.parametrize("held", [4, 128])
def test_skeleton_kernel_emulation_matches_plain(held):
    splats = sphere_cloud([12.0, 12.0, 16.0], 7.0, 9000, 3)
    bks = [bucket((0, 0, 0), (16, 16, 31)), bucket((16, 0, 0), (31, 16, 31)),
           bucket((0, 16, 0), (31, 31, 31))]
    skeleton_points(bks)
    checked = 0
    for bk in bks:
        b, s, ln, origin, region, points = binned_block(
            splats, bk.cell_lo, bk.cell_hi, bk.skeleton)
        field = mls.eval_field(b.entry_data, s, ln, origin, TPA, "sphere",
                               0.0)
        pts, lp, tid, inside = mls.skeleton_points(points, origin, TPA,
                                                   field.shape[0])
        ref_m, ref_h = mls.skeleton_moments(b.entry_data, b.entry_vals, s, ln,
                                            pts, tid, inside)
        m, h = emulate_skeleton(b.entry_data.numpy(), b.entry_vals.numpy(),
                                s.numpy(), ln.numpy(), pts.numpy(),
                                tid.numpy(), inside.numpy(), held)
        assert_equal_values(m, ref_m.numpy())
        np.testing.assert_array_equal(h, ref_h.numpy())
        ref = mls.skeleton_point_field(field.clone(), b.entry_data,
                                       b.entry_vals, s, ln, origin, points,
                                       TPA, "sphere", 0.0)
        got = mls.fit_points(field.clone(), torch.as_tensor(m),
                             torch.as_tensor(h), pts, lp, inside, "sphere",
                             0.0)
        assert_equal_values(got.numpy(), ref.numpy())
        checked += int((h >= 4).sum())
    assert checked > 20                  # the surface crosses the skeleton


# --- what the kernels' rounds rest on -----------------------------------------

def test_segments_list_each_splat_once_but_not_in_stream_order(face_cloud):
    """A tile's chain of level segments lists a splat at most once (a splat
    sits at one level, in up to 8 distinct nodes), so a face row lists it
    at most 4 times; but a segment's splats come corner-major (binning
    sorts entries c * N + i stably by node), in up to 8 ascending runs, not
    in stream order."""
    descending = 0
    for lo, hi in FACE_BLOCKS.values():
        b, s, ln, _, _, _ = binned_block(face_cloud, lo, hi)
        vals, starts, lens = (t.numpy() for t in (b.entry_vals, s, ln))
        for t in range(starts.shape[0]):
            chain = np.concatenate([vals[a:a + n] for a, n in
                                    zip(starts[t], lens[t])])
            assert len(np.unique(chain)) == len(chain)
            for a, n in zip(starts[t], lens[t]):
                runs = 1 + int((np.diff(vals[a:a + n]) < 0).sum())
                assert runs <= 8
                descending += runs > 1
    assert descending > 0


def test_fit_points_writes_only_the_points_inside():
    """The skeleton pass's scatter without a mask: points outside the block
    (or with a negative coordinate) leave the field as it was, also when
    no point is inside."""
    splats = sphere_cloud([12.0, 12.0, 16.0], 7.0, 9000, 3)
    bk = bucket((0, 16, 0), (31, 31, 31))
    skeleton_points([bucket((0, 0, 0), (16, 16, 31)),
                     bucket((16, 0, 0), (31, 16, 31)), bk])
    b, s, ln, origin, _, _ = binned_block(splats, bk.cell_lo, bk.cell_hi)
    field = mls.eval_field(b.entry_data, s, ln, origin, TPA, "sphere", 0.0)
    outside = np.array([[-1, 20, 3], [5, 80, 3], [40, 20, 3]], np.int64)
    for points in (np.concatenate([outside, bk.skeleton]), outside):
        pts = torch.as_tensor(points)
        got = mls.skeleton_point_field(field.clone(), b.entry_data,
                                       b.entry_vals, s, ln, origin, pts, TPA,
                                       "sphere", 0.0)
        p, lp, tid, inside = mls.skeleton_points(pts, origin, TPA,
                                                 field.shape[0])
        m, h = mls.skeleton_moments(b.entry_data, b.entry_vals, s, ln, p,
                                    tid, inside)
        vals = mls._fit(m, mls._point_frames(p)[1], h, "sphere", 0.0)[:, 0]
        want = field.clone()
        q = lp[inside]
        want[q[:, 2], q[:, 1], q[:, 0]] = vals[inside]
        assert_equal_values(got.numpy(), want.numpy())
        assert int(inside.sum()) == len(points) - len(outside)
