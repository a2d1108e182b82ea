"""Kernel-vs-plain gate for the MLS field kernel, for both fit shapes.

The kernel accumulates moments in another order than the plain version, so
the two agree to a tolerance rather than bitwise: the NaN (undefined)
pattern on more than 99.95% of corners (decision-boundary noise flips
isolated corners) and |kernel - plain| < 1e-3 where both are defined — the
JAX package's bar for its Pallas kernel (tests/test_mls_pallas.py:40-43,
mlsgpu_tpu/ops/kernel_gate.py:82).

`python -m mlsgpu_tpu_torch.ops.kernel_gate` runs the gate on the card
(exit 0 = pass).
"""

from __future__ import annotations

import numpy as np
import torch

MIN_AGREEMENT = 0.9995
MAX_ABS_ERR = 1e-3


def _gate_cloud(n: int = 1500, seed: int = 41) -> np.ndarray:
    """Deterministic synthetic sphere cloud in grid coordinates, sized for
    one 64^3-corner block (mlsgpu_tpu/ops/kernel_gate.py::_gate_cloud)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    out = np.empty((n, 8), np.float32)
    out[:, 0:3] = np.array([32.0, 31.0, 33.0]) + 18.0 * v
    out[:, 3] = 3.0
    out[:, 4:7] = v
    out[:, 7] = 1.0 / 9.0
    return out


def compare_fields(ref: torch.Tensor, got: torch.Tensor) -> dict:
    """NaN-pattern agreement and max |got - ref| where both are defined."""
    ref = ref.detach().cpu().numpy()
    got = got.detach().cpu().numpy()
    fr, fg = np.isfinite(ref), np.isfinite(got)
    both = fr & fg
    return {"pattern_agreement": float(np.mean(fr == fg)),
            "defined_corners": int(both.sum()),
            "max_abs_err": (float(np.abs(got[both] - ref[both]).max())
                            if both.any() else 0.0)}


def check(summary: dict, min_defined: int = 1) -> None:
    """Raise AssertionError when a comparison misses the bar."""
    if summary["pattern_agreement"] <= MIN_AGREEMENT:
        raise AssertionError(
            f"NaN-pattern agreement {summary['pattern_agreement']:.6f} "
            f"<= {MIN_AGREEMENT}")
    if summary["defined_corners"] < min_defined:
        raise AssertionError(
            f"only {summary['defined_corners']} corners defined")
    if summary["max_abs_err"] >= MAX_ABS_ERR:
        raise AssertionError(
            f"max |kernel - plain| = {summary['max_abs_err']:.3e}")


def run_kernel_gate(fit_shape: str = "sphere", device="cuda",
                    boundary_factor: float = 0.0) -> dict:
    """Kernel against plain version on one 64^3-corner block (levels 4,
    subsampling 3) of the JAX gate's synthetic sphere cloud, on a CUDA
    device. Raises AssertionError on divergence; returns the summary."""
    from mlsgpu_tpu_torch.ops import binning, mls, mls_cuda

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the kernel gate compares on a CUDA device")
    min_s, max_s = 3, 6
    tpa = 1 << (max_s - 3)
    splats = torch.as_tensor(_gate_cloud(), device=dev)
    valid = torch.ones(len(splats), dtype=torch.bool, device=dev)
    origin = (0, 0, 0)
    binned = binning.bin_splats(splats, valid, origin, min_s, max_s)
    starts, lens = binning.tile_segments(binned.entry_keys, min_s, max_s, tpa)
    ref = mls.eval_field(binned.entry_data, starts, lens, origin, tpa,
                         fit_shape, boundary_factor)
    got = mls_cuda.launch(binned.entry_data, starts, lens, origin, tpa,
                          fit_shape, boundary_factor)
    torch.cuda.synchronize(dev)
    summary = compare_fields(ref, got)
    check(summary, min_defined=500)
    return summary


def main() -> int:
    for fit in ("sphere", "plane"):
        print(f"kernel gate {fit}: OK {run_kernel_gate(fit)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
