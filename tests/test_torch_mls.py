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
def test_kernel_rerun_bitwise_on_card(cuda_device):
    args = _port_binned(_dense_cloud(), cuda_device)
    f1 = mls_cuda.launch(*args, (0, 0, 0), TPA, "sphere", 0.0)
    f2 = mls_cuda.launch(*args, (0, 0, 0), TPA, "sphere", 0.0)
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
