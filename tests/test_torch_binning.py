"""The port's binning against the JAX package's on the same splats: the clz
replacement over every edge value, node keys and tile segments bitwise,
the card's radix sort (its plain version binning.radix_sort) equal to the
JAX package's jax.lax.sort on keys of 3 to 11 levels,
entry splats equal as multisets per key (the JAX sort is not stable, so tie
order inside a node is not part of the contract). Besides the clouds of
this module, those of tests/test_torch_binning_cuda.py (`edge_cloud`):
splats on slab boundaries and at the conservative test's margin, off node
corners, and with giant radii."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlsgpu_tpu.ops import binning as jbin
from mlsgpu_tpu_torch.ops import binning as tbin

from tests import oracle
from tests.test_torch_binning_cuda import SORT_CASES, edge_cloud, sort_case

#: The clouds of edge_cloud this module runs as well as its own.
EDGE_KINDS = ("boundaries", "corners", "giant")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bit_length_matches_clz_edges():
    vals = {1, 2, 3}
    for k in range(1, 31):
        vals |= {(1 << k) - 1, 1 << k, (1 << k) + 1}
    vals = np.array(sorted(v for v in vals if v < 1 << 31), np.int64)
    ref = 32 - np.asarray(jax.lax.clz(jnp.asarray(vals.astype(np.int32))))
    got = tbin.bit_length(torch.as_tensor(vals)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_level_shift_matches_jax():
    big = np.concatenate([np.arange(0, 70), [127, 128, 129, 255, 256, 257,
                                             1023, 1024, 1025, 1 << 20]])
    ref = np.asarray(jbin._level_shift1(jnp.asarray(big.astype(np.int32))))
    got = tbin.level_shift(torch.as_tensor(big.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref)


def _cloud(kind):
    """(splats, valid, origin (3,) int32) of a test cloud."""
    if kind in EDGE_KINDS:
        splats, valid, origin = edge_cloud(kind)
        return splats, valid, np.asarray(origin, np.int32)
    rng = np.random.default_rng(12)
    if kind == "varied":
        small = oracle.sphere_cloud([16, 16, 16], 10.0, 800, 1.5, rng)
        large = oracle.sphere_cloud([16, 16, 16], 10.0, 150, 12.0, rng)
        s, origin = np.concatenate([small, large]), np.zeros(3, np.int32)
    elif kind == "offset":
        # block origin away from 0 and splats reaching outside the block
        s = oracle.plane_cloud(40.5, 40.0, 1500, 2.0, rng)
        s[:, 0:2] += 28.0
        origin = np.array([32, 32, 24], np.int32)
    else:
        s = oracle.sphere_cloud([16.0, 15.0, 17.0], 9.0, 1200, 2.0, rng)
        s[::97, 0] = np.nan                   # invalid rows sort last
        origin = np.zeros(3, np.int32)
    return s, np.isfinite(s).all(axis=1), origin


def _bin_both(kind, levels, sub):
    splats, valid, origin = _cloud(kind)
    min_s, max_s = sub, levels + sub - 1
    jb = jbin.bin_splats(jnp.asarray(splats), jnp.asarray(valid),
                         jnp.asarray(origin), min_s, max_s)
    tb = tbin.bin_splats(torch.as_tensor(splats), torch.as_tensor(valid),
                         tuple(origin), min_s, max_s)
    return jb, tb, (min_s, max_s)


@pytest.mark.parametrize("kind,levels,sub", [
    *(pytest.param(kind, 3, 3, id=kind)
      for kind in ("sphere", "varied", "offset", *EDGE_KINDS)),
    *(pytest.param(kind, 2, 5, id=f"{kind}-2-5") for kind in EDGE_KINDS)])
def test_entries_match_jax(kind, levels, sub):
    jb, tb, _ = _bin_both(kind, levels, sub)
    jkeys = np.asarray(jb.entry_keys).astype(np.int64)
    tkeys = tb.entry_keys.numpy()
    np.testing.assert_array_equal(tkeys, jkeys)              # bitwise
    assert (jkeys != tbin.INVALID_KEY).sum() > (
        100 if kind in EDGE_KINDS else 1000)

    # splats per key as multisets, and the entry rows per (key, val)
    jvals = np.asarray(jb.entry_vals).astype(np.int64)
    tvals = tb.entry_vals.numpy()
    jo = np.lexsort((jvals, jkeys))
    to = np.lexsort((tvals, tkeys))
    np.testing.assert_array_equal(jvals[jo], tvals[to])
    jdata = np.asarray(jb.entry_data)[jo]
    tdata = tb.entry_data.numpy()[to]
    np.testing.assert_array_equal(jdata.view(np.uint32), tdata.view(np.uint32))


LEVELS = [(3, 3), (4, 3), (3, 4), (2, 5)]


@pytest.mark.parametrize("levels,sub,kind", [
    *(pytest.param(lv, sub, "varied", id=f"{lv}-{sub}") for lv, sub in LEVELS),
    *(pytest.param(lv, sub, kind, id=f"{lv}-{sub}-{kind}")
      for kind in EDGE_KINDS for lv, sub in LEVELS)])
def test_tile_segments_bitwise(levels, sub, kind):
    """Includes min_shift > 3, where several tiles share one leaf node;
    the keys the segments are searched in are bitwise too."""
    jb, tb, (min_s, max_s) = _bin_both(kind, levels, sub)
    np.testing.assert_array_equal(tb.entry_keys.numpy(),
                                  np.asarray(jb.entry_keys).astype(np.int64))
    tpa = 1 << (max_s - 3)
    js, jl = jbin.tile_segments(jb.entry_keys, min_s, max_s, tpa)
    ts, tl = tbin.tile_segments(tb.entry_keys, min_s, max_s, tpa)
    assert ts.dtype == torch.int32 and ts.shape == (tpa ** 3, levels)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tl.sum()) > 0


@pytest.mark.parametrize("case", list(SORT_CASES))
def test_radix_sort_matches_jax_sort(case):
    """binning.radix_sort, the plain version of the card's sort, gives the
    keys and permutation of torch.sort(stable=True) and of the JAX
    package's jax.lax.sort((keys, vals), num_keys=1) (stable, uint32
    keys) on the same numpy keys: 3, 6, 7 and 11 levels, no invalid key,
    all invalid, heavy ties, one key and none."""
    keys, min_s, max_s = sort_case(case)
    got_k, got_p = tbin.radix_sort(torch.as_tensor(keys), min_s, max_s)
    want_k, want_p = torch.sort(torch.as_tensor(keys), stable=True)
    assert torch.equal(got_k, want_k) and torch.equal(got_p, want_p)
    jk, jp = jax.lax.sort((jnp.asarray(keys.astype(np.uint32)),
                           jnp.arange(len(keys), dtype=jnp.int32)),
                          num_keys=1)
    np.testing.assert_array_equal(got_k.numpy(),
                                  np.asarray(jk).astype(np.int64))
    np.testing.assert_array_equal(got_p.numpy(),
                                  np.asarray(jp).astype(np.int64))
