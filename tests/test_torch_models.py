"""The port's MLS fit models against the JAX package's on the same moments
(tests/test_mls.py fixtures plus random moments). Bar: identical NaN
pattern; |torch - jax| <= 1e-5 where finite (f32 arithmetic, same formulas;
the 3-term sums may round in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mlsgpu_tpu.models import common as jcommon
from mlsgpu_tpu.models.plane import plane_distance as jplane
from mlsgpu_tpu.models.sphere import sphere_distance as jsphere
from mlsgpu_tpu_torch.models import common as tcommon
from mlsgpu_tpu_torch.models.plane import plane_distance as tplane
from mlsgpu_tpu_torch.models.sphere import sphere_distance as tsphere

from tests import oracle

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def moments(splats, corner):
    """Corner-centred f32 moments (numpy form of tests/test_mls.py's
    _moments_from_splats)."""
    s = np.asarray(splats, np.float32)
    p = s[:, 0:3] - np.asarray(corner, np.float32)
    pp = np.sum(p * p, axis=1)
    d = pp * (np.float32(1.0) / s[:, 3] ** 2)
    keep = d < np.float32(0.99)
    w = np.where(keep, (1 - d) ** 4 * s[:, 7], 0).astype(np.float32)
    return (np.float32(w.sum()), (w @ p).astype(np.float32),
            np.float32(w @ pp), (w @ s[:, 4:7]).astype(np.float32),
            np.float32(w @ np.sum(s[:, 4:7] * p, axis=1)),
            np.int32(keep.sum()))


def fixture_moments():
    rng = np.random.default_rng(7)
    sphere = oracle.sphere_cloud([5.0, 6.0, 7.0], 3.0, 200, 4.0, rng)
    rows = [moments(sphere, c) for c in
            ([5.0, 6.0, 9.5], [5.0, 6.0, 5.5], [7.5, 6.0, 7.0])]
    few = oracle.sphere_cloud([0, 0, 0], 3.0, 3, 4.0,
                              np.random.default_rng(8))
    rows.append(moments(few, [0.0, 0.0, 3.2]))             # < 4 hits
    disc = oracle.plane_cloud(0.0, 4.0, 300, 1.0, np.random.default_rng(9))
    rows.append(moments(disc, [8.0, 2.0, 0.5]))            # one-sided
    plane = oracle.plane_cloud(2.0, 8.0, 500, 1.5, np.random.default_rng(10))
    rows += [moments(plane, [4.0, 4.0, z]) for z in (1.0, 2.5, 3.0)]
    # random corners around a noisy sphere: the bulk of the comparison
    rng = np.random.default_rng(11)
    noisy = oracle.sphere_cloud([0.0, 0.0, 0.0], 5.0, 400, 2.5, rng)
    noisy[:, 0:3] += rng.normal(scale=0.05, size=(400, 3)).astype(np.float32)
    rows += [moments(noisy, c) for c in rng.uniform(-7, 7, size=(200, 3))]
    return [np.stack(col) for col in zip(*rows)]


MOMENTS = fixture_moments()


def _compare(jfn, tfn, bf):
    jax_out = np.asarray(jfn(*[jnp.asarray(m) for m in MOMENTS],
                             boundary_factor=jnp.float32(bf)))
    torch_out = tfn(*[torch.as_tensor(m) for m in MOMENTS],
                    boundary_factor=bf).numpy()
    np.testing.assert_array_equal(np.isnan(jax_out), np.isnan(torch_out))
    fin = np.isfinite(jax_out)
    assert fin.sum() > 50 and (~fin).sum() > 2
    np.testing.assert_allclose(torch_out[fin], jax_out[fin], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("bf", [0.0, 0.75])
def test_sphere_matches_jax(bf):
    _compare(jsphere, tsphere, bf)


@pytest.mark.parametrize("bf", [0.0, 0.75])
def test_plane_matches_jax(bf):
    _compare(jplane, tplane, bf)


@pytest.mark.parametrize("a,b,c,expected", [
    (0.0, 2.0, -4.0, 2.0),     # linear
    (1.0, 0.0, -4.0, 2.0),     # larger root, a > 0
    (-1.0, 0.0, 4.0, -2.0),    # smaller root, a < 0
    (1.0, 4.0, 3.0, -1.0),
    (1.0, 0.0, 1.0, None),     # no real root
    (0.0, 0.0, 0.0, None),     # degenerate
])
def test_solve_quadratic_cases(a, b, c, expected):
    got = float(tcommon.solve_quadratic(*(torch.tensor(v, dtype=torch.float32)
                                          for v in (a, b, c))))
    ref = float(jcommon.solve_quadratic(*(jnp.float32(v) for v in (a, b, c))))
    if expected is None:
        assert np.isnan(got) and np.isnan(ref)
    else:
        assert got == pytest.approx(expected, abs=1e-5)
        assert got == pytest.approx(ref, abs=ATOL)


def test_solve_quadratic_random_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=2000).astype(np.float32)
    b = np.abs(rng.normal(size=2000)).astype(np.float32)
    c = rng.normal(size=2000).astype(np.float32)
    a[:100] = 0.0
    c[100:200] = 0.0
    got = tcommon.solve_quadratic(torch.as_tensor(a), torch.as_tensor(b),
                                  torch.as_tensor(c)).numpy()
    ref = np.asarray(jcommon.solve_quadratic(jnp.asarray(a), jnp.asarray(b),
                                             jnp.asarray(c)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("bf", [0.0, 0.75])
def test_boundary_accept_matches_jax(bf):
    rng = np.random.default_rng(5)
    n = 1000
    args = [rng.normal(size=n).astype(np.float32),               # q_den
            np.abs(rng.normal(size=n)).astype(np.float32) * 4,   # sum_wpp
            rng.normal(size=(n, 3)).astype(np.float32),          # sum_wp
            np.abs(rng.normal(size=n)).astype(np.float32),       # sum_w
            rng.normal(size=(n, 3)).astype(np.float32)]          # a_vec
    got = tcommon.boundary_accept(*[torch.as_tensor(x) for x in args],
                                  bf).numpy()
    ref = np.asarray(jcommon.boundary_accept(*[jnp.asarray(x) for x in args],
                                             jnp.float32(bf)))
    np.testing.assert_array_equal(got, ref)
    assert got.any() and not got.all()
