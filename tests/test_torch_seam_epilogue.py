"""The seam kernels' epilogue, held on the CPU (csrc/seam_moments.cu has no
CPU mode): what the kernels compute after the moments, written out in
numpy float32 in the kernels' own order, against the plain versions.

- The fit: a line-for-line transcription of the kernel's `fit` (the
  moments re-centred on the corner, then `sphere_fit` or `plane_fit`, each
  product, sum, quotient and root rounded on its own, as the kernel's
  __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn do) equals
  ops/mls.py::_fit bit for bit for both fits: on moments summed from
  splats around a corner, and on the edge cases (sum_w 0, hits below 4,
  the instability guard, a negative discriminant, NaN moments).
- The write: the kernel's rows (`face_row`, from the row index and the
  block's scalars) are mls.face_rows', and writing each row corner where
  `owned_index` puts it (the last face in write_faces' order that covers
  it) gives write_faces' field, on blocks whose origins are multiples of
  8 or not (also negative), with patches that straddle the block's
  in-plane edge, and with two planes of one axis that coincide.
- The memory estimate's seam reserve follows the kernel attributes read
  at run time (stubbed here: the library builds only on the card).

Fixtures are built inline (no jax, no tests.oracle).
"""

import numpy as np
import pytest
import torch

from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.ops import mls, seam_cuda
from mlsgpu_tpu_torch.pipeline import resources

F32 = np.float32
EPS4 = F32(4 * 1.1920929e-07)       # torch's f32 of (4 * FLT_EPSILON)


def assert_same_bits(got, ref):
    """NaN where ref is NaN; every other value the same bits (so the sign
    of a zero too)."""
    got, ref = np.asarray(got, F32), np.asarray(ref, F32)
    assert got.shape == ref.shape
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bad = got[~nan].view(np.uint32) != ref[~nan].view(np.uint32)
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} values differ"


# --- the fit, as the kernel writes it ------------------------------------------

def dot3(a, b):
    """(a0 b0 + a1 b1) + a2 b2, each step rounded (models/common.py)."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def boundary_accept(q_den, wpp, wp, sum_w, av, bf):
    aa = dot3(av, av)
    rhs = (wpp - F32(2.0) * dot3(wp, av)) + sum_w * aa
    return (aa < F32(3.0)) & (q_den > F32(bf) * rhs)


def sphere_fit(sum_w, wp, wpp, sn, wpn, hits, bf):
    inv = F32(1.0) / sum_w
    m = [wp[k] * inv for k in range(3)]
    q_num = wpn - dot3(m, sn)
    q_den = wpp - dot3(m, wp)
    q = q_num / q_den
    unstable = np.abs(q_den) < (EPS4 * hits.astype(F32)) * np.abs(wpp)
    q = np.where(unstable | ~np.isfinite(q), F32(0.0), q)
    qa = F32(0.5) * q
    b = [(sn[k] - q * wp[k]) * inv for k in range(3)]
    c = (-qa * wpp - dot3(b, wp)) * inv
    b2 = dot3(b, b)
    sa = qa * b2
    bdet = b2 + np.sqrt(b2 * b2 - (F32(4.0) * sa) * c)
    x1 = (F32(-2.0) * c) / bdet
    x2 = bdet / (F32(-2.0) * sa)
    l = np.where(np.isfinite(x1), x1, x2)
    l = np.where(np.isfinite(l), l, F32(np.nan))
    av = [l * b[k] for k in range(3)]
    accept = boundary_accept(q_den, wpp, wp, sum_w, av, bf)
    f = -dot3(b, av) / np.sqrt(b2)
    return np.where(accept & (hits >= 4), f, F32(np.nan))


def plane_fit(sum_w, wp, wpp, sn, hits, bf):
    mean = [wp[k] / sum_w for k in range(3)]
    norm = np.sqrt(dot3(sn, sn))
    nrm = [sn[k] / norm for k in range(3)]
    dist = -dot3(nrm, mean)
    av = [nrm[k] * -dist for k in range(3)]
    q_den = wpp - dot3(mean, wp)
    accept = boundary_accept(q_den, wpp, wp, sum_w, av, bf)
    return np.where(accept & (hits >= 4), dist, F32(np.nan))


def fit_np(m, corner, hits, fit_shape, bf):
    """csrc/seam_moments.cu::fit over moments (..., 9), corners (..., 3)
    in the same frame and hits (...) int32; returns (...) f32."""
    m = np.asarray(m, F32)
    corner = np.asarray(corner, F32)
    c = [corner[..., k] for k in range(3)]
    with np.errstate(all="ignore"):
        sum_w = m[..., 0]
        wp = [m[..., 1 + k] - c[k] * sum_w for k in range(3)]
        wpp = ((m[..., 4] - F32(2.0) * dot3(c, [m[..., 1], m[..., 2],
                                                m[..., 3]]))
               + dot3(c, c) * sum_w)
        sn = [m[..., 5], m[..., 6], m[..., 7]]
        wpn = m[..., 8] - dot3(c, sn)
        if fit_shape == "plane":
            return plane_fit(sum_w, wp, wpp, sn, hits, bf)
        return sphere_fit(sum_w, wp, wpp, sn, wpn, hits, bf)


def _moments_near_a_surface(rng, n):
    """Moments, corners and hits of n corners, each summed (f32, in
    order) from 3-40 splats on a sphere cap that passes near it."""
    corners = rng.integers(0, 8, size=(n, 3)).astype(F32)
    m = np.zeros((n, 9), F32)
    hits = rng.integers(3, 41, size=n).astype(np.int32)
    for i in range(n):
        k = int(hits[i])
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        radius = rng.uniform(3.0, 12.0)
        centre = corners[i] + (radius + rng.normal(0, 0.3)) * u
        v = u + 0.3 * rng.normal(size=(k, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        x = (centre - radius * v).astype(F32)
        nrm = (-v).astype(F32)
        w = rng.uniform(0.01, 1.0, size=k).astype(F32)
        feats = np.concatenate(
            [np.ones((k, 1), F32), x, dot3(x.T, x.T)[:, None], nrm,
             dot3(nrm.T, x.T)[:, None]], axis=1)
        for t in feats * w[:, None]:
            m[i] += t
    return m, corners, hits


def _edge_case(name, rng, n=2000):
    m, corners, hits = _moments_near_a_surface(rng, n)
    if name == "sum_w_zero":
        m[: n // 2] = 0.0
        hits[: n // 4] = 0
        hits[n // 4: n // 2] = 5
    elif name == "hits_below_4":
        hits[:] = rng.integers(0, 4, size=n)
    elif name == "guard":
        # splats on one point: q_den ~ 0 against |sum_wpp|
        for i in range(n):
            x = rng.normal(0, 3, 3).astype(F32)
            nrm = rng.normal(size=3).astype(F32)
            w = F32(rng.uniform(0.1, 1.0))
            t = np.concatenate([[1.0], x, [dot3(x, x)], nrm, [dot3(nrm, x)]]
                               ).astype(F32) * w
            m[i] = 0.0
            for _ in range(int(hits[i])):
                m[i] += t
    elif name == "negative_discriminant":
        m = (rng.uniform(-1, 1, size=(n, 9))
             * np.exp2(rng.integers(-6, 6, size=(n, 9)))).astype(F32)
        m[:, 0] = np.abs(m[:, 0])
        hits[:] = 10
    elif name == "nan_moments":
        pick = rng.random(size=m.shape) < 0.1
        m[pick] = np.nan
        m[rng.random(size=m.shape) < 0.02] = np.inf
    return m, corners, hits


CASES = ["near_a_surface", "sum_w_zero", "hits_below_4", "guard",
         "negative_discriminant", "nan_moments"]


@pytest.fixture
def ieee_sqrt(monkeypatch):
    """torch.sqrt correctly rounded, as the card's is (chip_smoke.py's
    probe) and the kernel's __fsqrt_rn: torch's CPU sqrt of a float32
    tensor (MKL's vector sqrt) is not; it differs from np.sqrt in the last
    bit of some 0.7% of values."""
    def sqrt(t):
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(t.numpy()))
    monkeypatch.setattr(torch, "sqrt", sqrt)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fit_shape,bf", [("sphere", 0.0), ("plane", 0.75)])
def test_kernel_fit_is_the_plain_fit_bit_for_bit(fit_shape, bf, case,
                                                 ieee_sqrt):
    rng = np.random.default_rng(CASES.index(case))
    m, corners, hits = _edge_case(case, rng)
    got = fit_np(m, corners, hits, fit_shape, bf)
    ref = mls._fit(torch.as_tensor(m), torch.as_tensor(corners),
                   torch.as_tensor(hits), fit_shape, bf).numpy()
    assert_same_bits(got, ref)
    # the case is really there
    with np.errstate(all="ignore"):
        if case == "near_a_surface":
            assert (~np.isnan(ref)).sum() > ref.size // 4
        elif case == "guard" and fit_shape == "sphere":
            sum_w = m[:, 0]
            wp = m[:, 1:4] - corners * sum_w[:, None]
            wpp = ((m[:, 4] - F32(2.0) * dot3(corners.T, m[:, 1:4].T))
                   + dot3(corners.T, corners.T) * sum_w)
            q_den = wpp - dot3((wp * (F32(1.0) / sum_w)[:, None]).T, wp.T)
            assert (np.abs(q_den) < (EPS4 * hits) * np.abs(wpp)).sum() > 100
        elif case == "negative_discriminant":
            assert np.isnan(ref).sum() > 100


# --- the rows and the write, as the kernel does them ------------------------------

def face_row_np(r, origin, region, tpa):
    """csrc/seam_moments.cu::face_row: (a, b, c, plane, base_a, base_b,
    base_c, tiles) of row r, with >> for floor division by 8."""
    np_ = tpa + 1
    f2 = np_ * np_
    face = r // f2
    a = face >> 1
    b, c = (a + 1) % 3, (a + 2) % 3
    side, q = face & 1, r - face * f2
    plane = origin[a] + (region[a] if side else 0)
    base_a = (plane >> 3) * 8
    base_b = ((origin[b] >> 3) + q // np_) * 8
    base_c = ((origin[c] >> 3) + q % np_) * 8
    layer = region[a] >> 3 if side else 0
    lob, loc = base_b - origin[b], base_c - origin[c]

    def clamp(v):
        return min(max(v, 0), tpa - 1)

    tb = (clamp(lob >> 3), clamp((lob + 7) >> 3))
    tc = (clamp(loc >> 3), clamp((loc + 7) >> 3))

    def tile(tbv, tcv):
        t = [0, 0, 0]
        t[a], t[b], t[c] = layer, tbv, tcv
        return (t[2] * tpa + t[1]) * tpa + t[0]

    tiles = [tile(tb[0], tc[0]), tile(tb[0], tc[1]), tile(tb[1], tc[0]),
             tile(tb[1], tc[1])]
    return a, b, c, plane, base_a, base_b, base_c, tiles


def owned_index(row, k, origin, region, tpa):
    """csrc/seam_moments.cu::owned_index: the field index of row corner k
    (b = k // 8, c = k % 8), or -1 outside the block or where a later face
    covers it."""
    bdim = 8 * tpa
    r, (a, b, c, plane, _, base_b, base_c, _) = row
    face = r // ((tpa + 1) ** 2)
    xyz = [0, 0, 0]
    xyz[a] = plane - origin[a]
    xyz[b] = base_b + k // 8 - origin[b]
    xyz[c] = base_c + k % 8 - origin[c]
    if not (0 <= xyz[b] < bdim and 0 <= xyz[c] < bdim):
        return -1
    for g in range(face + 1, 6):
        if xyz[g >> 1] == (region[g >> 1] if g & 1 else 0):
            return -1
    return (xyz[2] * bdim + xyz[1]) * bdim + xyz[0]


def kernel_write_faces(field, out, origin, region, tpa):
    """Each row corner of `out` (R, 64) written where owned_index puts it:
    the kernel's write, in place on the numpy `field`."""
    flat = field.reshape(-1)
    origin, region = mls.host_ints(origin), mls.host_ints(region)
    for r in range(out.shape[0]):
        row = (r, face_row_np(r, origin, region, tpa))
        for k in range(64):
            at = owned_index(row, k, origin, region, tpa)
            if at >= 0:
                flat[at] = out[r, k]
    return field


# (origin, region, tiles per axis)
WRITE_BLOCKS = {
    "aligned": ((0, 0, 0), (31, 31, 31), 4),
    "origin_not_multiple_of_8": ((3, 21, 13), (28, 20, 31), 4),
    "negative_origin": ((-13, -8, 5), (16, 31, 9), 4),
    "straddling": ((0, 3, 0), (28, 31, 31), 4),
    "coinciding_planes": ((5, 0, -3), (0, 23, 0), 4),
    "small": ((-1, 6, 9), (7, 7, 2), 1),
}


@pytest.mark.parametrize("block", sorted(WRITE_BLOCKS))
def test_kernel_rows_are_face_rows(block):
    origin, region, tpa = WRITE_BLOCKS[block]
    rows = mls.face_rows(origin, region, tpa)
    for r, ref in enumerate(rows):
        a, _, _, plane, base_a, base_b, base_c, tiles = face_row_np(
            r, list(origin), list(region), tpa)
        assert [a, plane, base_a, base_b, base_c, *tiles] == ref.tolist()


@pytest.mark.parametrize("block", sorted(WRITE_BLOCKS))
def test_kernel_ownership_is_write_faces(block):
    origin, region, tpa = WRITE_BLOCKS[block]
    n = 6 * (tpa + 1) ** 2
    b = 8 * tpa
    # distinct values, and a field whose untouched corners show
    out = (np.arange(n * 64, dtype=F32).reshape(n, 64) + F32(0.5))
    base = -np.arange(b ** 3, dtype=F32).reshape(b, b, b) - F32(1.0)
    ref = mls.write_faces(torch.as_tensor(base.copy()), torch.as_tensor(out),
                          origin, region, tpa).numpy()
    got = kernel_write_faces(base.copy(), out, origin, region, tpa)
    assert_same_bits(got, ref)
    assert (got != base).sum() > 0


# --- the memory estimate's seam reserve ------------------------------------------

def test_seam_reserve_follows_the_kernel_attributes(monkeypatch):
    """validate_device reads the seam kernels' local memory and the card's
    multiprocessors and threads at run time; the card estimate carries
    their product, and no moments or fit temporaries."""
    cfg = ReconstructConfig()
    card = torch.device("cuda", 0)
    seen = []

    def attributes(dev, local=48):
        seen.append(dev)
        return {"local_bytes": local, "multiprocessors": 114,
                "threads_per_multiprocessor": 1536}

    assert resources.seam_local_reserve(card, attributes) == 48 * 114 * 1536
    assert seen == [card]
    assert resources.seam_local_reserve(
        card, lambda d: attributes(d, 0)) == 0
    bare = resources.estimate_block_usage(cfg, "codes", "cuda")
    assert bare["faces"] == 0
    monkeypatch.setattr(seam_cuda, "kernel_attributes", attributes)
    monkeypatch.setattr(resources, "device_memory_bytes", lambda dev: 1 << 40)
    usage = resources.validate_device(cfg, [card], "codes")
    assert usage["faces"] == 48 * 114 * 1536
    assert usage["total"] == bare["total"] + 48 * 114 * 1536
    monkeypatch.setattr(resources, "device_memory_bytes",
                        lambda dev: int(bare["total"] / 0.9) + 1)
    with pytest.raises(resources.InvalidOption):
        resources.validate_device(cfg, [card], "codes")
