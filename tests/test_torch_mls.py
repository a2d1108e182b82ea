"""The MLS field: the port's plain `eval_field` against the JAX package's
`mls.eval_field` on the same (JAX-binned) entries, and the CUDA kernel
against the plain version on the card.

Bar (the JAX package's own for its Pallas kernel, tests/test_mls_pallas.py:
40-43): NaN-pattern agreement > 0.9995 and |Δ| < 1e-3 where both are
defined — the moment sums run in another order.

The port's GPU hosts need no jax, so this module imports jax only inside
its JAX-side tests and fixture: the `cuda` tests run where jax is absent,
with `python -m pytest --noconftest -m cuda tests/test_torch_mls.py`
(tests/conftest.py imports jax).
"""

import numpy as np
import pytest
import torch

from mlsgpu_tpu_torch.convert import binned_from_numpy
from mlsgpu_tpu_torch.ops import binning, kernel_gate, mls, mls_cuda

LEVELS, SUB = 3, 3
TPA = 1 << (LEVELS + SUB - 1 - 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    oversubscribed torch threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense_cloud():
    """Splats on a sphere with outward normals (tests/oracle.py's
    sphere_cloud), dense enough that some level segment holds more than
    128 entries, with the far corner of the block empty."""
    rng = np.random.default_rng(32)
    v = rng.normal(size=(4000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    out = np.empty((4000, 8), np.float32)
    out[:, 0:3] = np.array([14.0, 14.0, 15.0]) + 9.0 * v
    out[:, 3] = 2.5
    out[:, 4:7] = v
    out[:, 7] = 1.0 / 2.5 ** 2
    return out


@pytest.fixture(scope="module")
def jax_binned():
    import jax.numpy as jnp
    from mlsgpu_tpu.ops import binning as jbin
    splats = _dense_cloud()
    origin = jnp.zeros(3, jnp.int32)
    jb = jbin.bin_splats(jnp.asarray(splats), jnp.ones(len(splats), bool),
                         origin, SUB, LEVELS + SUB - 1)
    starts, lens = jbin.tile_segments(jb.entry_keys, SUB, LEVELS + SUB - 1,
                                      TPA)
    return jb, np.array(starts), np.array(lens)


def _port_inputs(jb, starts, lens, device="cpu"):
    b = binned_from_numpy(np.asarray(jb.entry_data), np.asarray(jb.entry_keys),
                          np.asarray(jb.entry_vals), device=device)
    return (b.entry_data, torch.as_tensor(starts, device=device),
            torch.as_tensor(lens, device=device))


@pytest.mark.parametrize("fit", ["sphere", "plane"])
@pytest.mark.parametrize("bf", [0.0, 0.75])
def test_eval_field_matches_jax(jax_binned, fit, bf):
    import jax.numpy as jnp
    from mlsgpu_tpu.ops import mls as jmls
    jb, starts, lens = jax_binned
    assert lens.max() > 128          # a segment longer than 128 entries
    k = int(lens.sum(axis=1).max())  # JAX cap >= every tile total
    ref, max_total = jmls.eval_field(jb.entry_data, jnp.asarray(starts),
                                     jnp.asarray(lens), jnp.zeros(3, jnp.int32),
                                     TPA, k, fit, jnp.float32(bf), tile_chunk=8)
    assert int(max_total) <= k
    got = mls.eval_field(*_port_inputs(jb, starts, lens), (0, 0, 0), TPA,
                         fit, bf)
    summary = kernel_gate.compare_fields(torch.as_tensor(np.array(ref)), got)
    kernel_gate.check(summary, min_defined=2000)
    assert np.isnan(got[-1, -1, -1].item())            # empty tile
    assert (lens.sum(axis=1) == 0).any()


def test_eval_field_uncapped_chunking(jax_binned):
    """Chunk width follows each chunk's largest tile total: results do not
    depend on how tiles are chunked."""
    jb, starts, lens = jax_binned
    args = _port_inputs(jb, starts, lens)
    a = mls.eval_field(*args, (0, 0, 0), TPA, "sphere", 0.0, tile_chunk=32)
    b = mls.eval_field(*args, (0, 0, 0), TPA, "sphere", 0.0, tile_chunk=3)
    np.testing.assert_array_equal(np.isnan(a.numpy()), np.isnan(b.numpy()))
    fin = np.isfinite(a.numpy())
    np.testing.assert_allclose(a.numpy()[fin], b.numpy()[fin], atol=1e-5)


def test_dispatch_cpu_uses_plain_version(jax_binned):
    jb, starts, lens = jax_binned
    args = _port_inputs(jb, starts, lens)
    before = mls_cuda.launches
    field, max_total, n_occ = mls_cuda.eval_field(*args, (0, 0, 0), TPA,
                                                  "sphere", 0.0)
    assert mls_cuda.launches == before
    assert max_total == 0
    assert int(n_occ) == int((lens.sum(axis=1) > 0).sum())
    plain = mls.eval_field(*args, (0, 0, 0), TPA, "sphere", 0.0)
    np.testing.assert_array_equal(field.numpy().view(np.uint32),
                                  plain.numpy().view(np.uint32))


def test_candidate_work_counts(jax_binned):
    """The work behind the kernel's bound: pairs are every occupied tile's
    candidates times its 512 corners; the reached pairs those whose
    candidate passes its corner's 8x4x4 box test, a superset of the hits;
    hits the pairs with d < 0.99 counted in numpy in the kernel's operation
    order; all whatever the tile chunking."""
    jb, starts, lens = jax_binned
    entries, st, ln = _port_inputs(jb, starts, lens)
    origin = (0, 0, 0)                  # the binning's
    pairs, reached, hits = mls.candidate_work(entries, st, ln, origin, TPA)
    assert pairs == int(lens.sum()) * 512
    assert (pairs, reached, hits) == mls.candidate_work(
        entries, st, ln, origin, TPA, tile_chunk=3)
    e = entries.numpy()
    c = np.stack(np.meshgrid(*[np.arange(8, dtype=np.float32)] * 3,
                             indexing="ij"), -1).reshape(-1, 3)
    # each corner's box: x 0..7, y and z a half of the tile each
    lo = np.concatenate([np.zeros((512, 1), np.float32),
                         np.float32(4) * (c[:, 1:3] // 4)], 1)[:, None, :]
    hi = lo + np.float32([7, 3, 3])
    want = want_reached = 0
    for t in np.nonzero(lens.sum(1))[0]:
        rows = np.concatenate([np.arange(a, a + n) for a, n in
                               zip(starts[t], lens[t])])
        tz, ty, tx = t // (TPA * TPA), (t // TPA) % TPA, t % TPA
        g = np.array([tx * 8 + origin[0], ty * 8 + origin[1],
                      tz * 8 + origin[2]], np.float32)
        x = e[rows, 0:3] - g
        x2 = (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2]
        dot = ((c[:, None, 0] * x[None, :, 0] + c[:, None, 1] * x[None, :, 1])
               + c[:, None, 2] * x[None, :, 2])
        cc = (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]) + c[:, 2] * c[:, 2]
        d = (x2[None, :] - np.float32(2) * dot + cc[:, None]) * e[rows, 3]
        hit = d < np.float32(0.99)
        want += int(hit.sum())
        out = np.maximum(np.maximum(lo - x[None], x[None] - hi), 0)
        dist2 = (out * out).sum(-1, dtype=np.float32)
        slack = np.float32(4e-6) * (x2 + np.float32(150))
        reach = ~((dist2 - slack[None, :]) * e[rows, 3] >= np.float32(0.99))
        assert not (hit & ~reach).any()     # the box test is conservative
        want_reached += int(reach.sum())
    assert 0 < hits == want < reached == want_reached < pairs


def _random_lens(num_tiles, levels, seed):
    """Segment lengths with many empty tiles and totals in every class."""
    rng = np.random.default_rng(seed)
    lens = (rng.integers(0, 60, size=(num_tiles, levels))
            * rng.random((num_tiles, 1))).astype(np.int32)
    lens[rng.random(num_tiles) < 0.6] = 0
    return torch.as_tensor(lens)


def test_tile_order_plain_is_longest_first():
    lens = _random_lens(4096, 6, 3)
    order, n_occ = mls_cuda.tile_order_plain(lens)
    totals = lens.sum(1)[order.long()]
    assert int(n_occ) == int((lens.sum(1) > 0).sum()) > 0
    assert (totals[:int(n_occ)] > 0).all() and (totals[int(n_occ):] == 0).all()
    cls = 7 - torch.clamp(totals[:int(n_occ)] // 32, max=7)
    assert (cls[1:] >= cls[:-1]).all() and cls.min() == 0 and cls.max() == 7
    same = cls[1:] == cls[:-1]
    assert (order[1:int(n_occ)][same] > order[:int(n_occ) - 1][same]).all()
    assert sorted(order.tolist()) == list(range(4096))


def test_kernel_launch_rejects_cpu_tensors(jax_binned):
    jb, starts, lens = jax_binned
    with pytest.raises(ValueError, match="CUDA"):
        mls_cuda.launch(*_port_inputs(jb, starts, lens), (0, 0, 0), TPA,
                        "sphere", 0.0)


def _port_binned(splats, device):
    """(entry_data, starts, lens) of the port's own binning on `device`."""
    sp = torch.as_tensor(splats, device=device)
    valid = torch.ones(len(sp), dtype=torch.bool, device=device)
    b = binning.bin_splats(sp, valid, (0, 0, 0), SUB, LEVELS + SUB - 1)
    s, ln = binning.tile_segments(b.entry_keys, SUB, LEVELS + SUB - 1, TPA)
    return b.entry_data, s, ln


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("fit", ["sphere", "plane"])
@pytest.mark.parametrize("bf", [0.0, 0.75])
def test_kernel_matches_plain_on_card(cuda_device, fit, bf):
    args = _port_binned(_dense_cloud(), cuda_device)
    assert int(args[2].max()) > 128
    before = mls_cuda.launches
    got, _, _ = mls_cuda.eval_field(*args, (0, 0, 0), TPA, fit, bf)
    assert mls_cuda.launches == before + 1
    ref = mls.eval_field(*args, (0, 0, 0), TPA, fit, bf)
    torch.cuda.synchronize()
    kernel_gate.check(kernel_gate.compare_fields(ref, got), min_defined=2000)


@pytest.mark.cuda
@pytest.mark.parametrize("fit", ["sphere", "plane"])
def test_kernel_gate_on_card(cuda_device, fit):
    summary = kernel_gate.run_kernel_gate(fit, cuda_device)
    assert summary["defined_corners"] > 500


@pytest.mark.cuda
@pytest.mark.parametrize("fit", ["sphere", "plane"])
def test_kernel_rerun_bitwise_on_card(cuda_device, fit):
    args = _port_binned(_dense_cloud(), cuda_device)
    f1 = mls_cuda.launch(*args, (0, 0, 0), TPA, fit, 0.0)
    f2 = mls_cuda.launch(*args, (0, 0, 0), TPA, fit, 0.0)
    assert torch.equal(f1.view(torch.int32), f2.view(torch.int32))


@pytest.mark.slow
@pytest.mark.parametrize("fit", ["sphere", "plane"])
def test_eval_field_matches_pallas_interpret(jax_binned, fit):
    """The plain version against the Pallas kernel itself, run as the JAX
    package's own tests run it on the CPU (interpret mode)."""
    import jax.numpy as jnp
    from mlsgpu_tpu.ops.mls_pallas import eval_field_pallas
    jb, starts, lens = jax_binned
    ref, _, _ = eval_field_pallas(jb.entry_data, jnp.asarray(starts),
                                  jnp.asarray(lens), jnp.zeros(3, jnp.int32),
                                  TPA, fit_shape=fit, boundary_factor=0.0,
                                  interpret=True)
    got = mls.eval_field(*_port_inputs(jb, starts, lens), (0, 0, 0), TPA,
                         fit, 0.0)
    summary = kernel_gate.compare_fields(torch.as_tensor(np.array(ref)), got)
    kernel_gate.check(summary, min_defined=2000)


#: Candidate entries a warp stages per pass (csrc/mls_field.cu WARP_CHUNK).
KERNEL_CHUNK = 32


@pytest.mark.cuda
@pytest.mark.parametrize("fit", ["sphere", "plane"])
def test_kernel_chunk_counts_on_card(cuda_device, fit):
    """Tiles with no candidates, with one chunk of them and with several:
    all against the plain version, the empty ones NaN."""
    entries, starts, lens = _port_binned(_dense_cloud(), cuda_device)
    totals = lens.sum(1).cpu()
    assert (totals == 0).any()
    assert ((totals > 0) & (totals <= KERNEL_CHUNK)).any()
    assert (totals > 2 * KERNEL_CHUNK).any()
    got = mls_cuda.launch(entries, starts, lens, (0, 0, 0), TPA, fit, 0.0)
    ref = mls.eval_field(entries, starts, lens, (0, 0, 0), TPA, fit, 0.0)
    torch.cuda.synchronize()
    kernel_gate.check(kernel_gate.compare_fields(ref, got), min_defined=2000)
    tiles = got.reshape(TPA, 8, TPA, 8, TPA, 8).permute(0, 2, 4, 1, 3, 5)
    empty = (totals == 0).reshape(TPA, TPA, TPA).to(cuda_device)
    assert torch.isnan(tiles[empty]).all()


@pytest.mark.cuda
def test_kernel_no_occupied_tile_on_card(cuda_device):
    entries, starts, lens = _port_binned(_dense_cloud(), cuda_device)
    before = mls_cuda.launches
    got, _, n_occ = mls_cuda.eval_field(entries, starts,
                                        torch.zeros_like(lens), (0, 0, 0),
                                        TPA, "sphere", 0.0)
    assert mls_cuda.launches == before + 1 and int(n_occ) == 0
    assert got.shape == (8 * TPA,) * 3 and torch.isnan(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tpa", [4, 32, 64])
@pytest.mark.parametrize("fit", ["sphere", "plane"])
def test_kernel_tiles_per_axis_on_card(cuda_device, tpa, fit):
    """Blocks of 32, 256 and 512 corners per axis (the levels that give
    them): small spheres along the block's diagonal, out to its far
    corner."""
    b = 8 * tpa
    rng = np.random.default_rng(tpa)
    centres = np.arange(16.0, b, 32.0)
    n = 1500
    parts = []
    for c in centres:
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        sp = np.empty((n, 8), np.float32)
        sp[:, 0:3] = c + 9.0 * v
        sp[:, 3] = 2.5
        sp[:, 4:7] = v
        sp[:, 7] = 1.0 / 2.5 ** 2
        parts.append(sp)
    splats = np.concatenate(parts)
    max_s = int(np.log2(tpa)) + 3
    sp = torch.as_tensor(splats, device=cuda_device)
    binned = binning.bin_splats(sp, torch.ones(len(sp), dtype=torch.bool,
                                               device=cuda_device),
                                (0, 0, 0), SUB, max_s)
    starts, lens = binning.tile_segments(binned.entry_keys, SUB, max_s, tpa)
    args = (binned.entry_data, starts, lens, (0, 0, 0), tpa, fit, 0.0)
    got = mls_cuda.launch(*args)
    ref = mls.eval_field(*args)
    torch.cuda.synchronize()
    assert got.shape == (b, b, b)
    assert torch.isfinite(got[-16, -16, -16 - 9]).item()   # far sphere
    kernel_gate.check(kernel_gate.compare_fields(ref, got),
                      min_defined=2000 * len(centres))


@pytest.mark.cuda
@pytest.mark.parametrize("tpa", [4, 32, 64])
def test_tile_order_kernel_on_card(cuda_device, tpa):
    """The order kernels equal their plain version bit for bit, and an
    all-empty block orders every tile as empty."""
    lens = _random_lens(tpa ** 3, 7, tpa).to(cuda_device)
    for case in (lens, torch.zeros_like(lens)):
        got, n_got = mls_cuda.tile_order(case)
        ref, n_ref = mls_cuda.tile_order_plain(case)
        assert torch.equal(got, ref) and int(n_got) == int(n_ref)
