"""Shared pieces of the MLS fit models (port of mlsgpu_tpu/models/common.py).

Three-component dot products are written out in a fixed order (`dot3`)
rather than reduced with `torch.sum`: a library reduction may combine the
terms in a shape-dependent order, and the seam contract needs two blocks to
round identically. csrc/mls_field.cu uses the same order.
"""

from __future__ import annotations

import torch

RADIUS_CUTOFF = 0.99   # kernels/mls.cl:36
HITS_CUTOFF = 4        # kernels/mls.cl:37
FLT_EPSILON = 1.1920929e-07


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing axis of size 3, as (a0 b0 + a1 b1) + a2 b2."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def solve_quadratic(a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """Root of ax^2 + bx + c that is larger (a > 0) or smaller (a < 0); NaN
    if no real root. Requires b >= 0. Branch-free citardauq form
    (kernels/mls.cl:237-248) with the classical form where it degenerates."""
    bdet = b + torch.sqrt(b * b - 4.0 * a * c)
    x1 = -2.0 * c / bdet
    x2 = bdet / (-2.0 * a)
    x = torch.where(torch.isfinite(x1), x1, x2)
    return torch.where(torch.isfinite(x), x, torch.full_like(x, float("nan")))


def boundary_accept(q_den, sum_wpp, sum_wp, sum_w, a_vec,
                    boundary_factor: float) -> torch.Tensor:
    """Boundary-rejection test (kernels/mls.cl:394-426): keep a corner only
    when the fitted region is not too one-sided around `a_vec`."""
    aa = dot3(a_vec, a_vec)
    rhs = sum_wpp - 2.0 * dot3(sum_wp, a_vec) + sum_w * aa
    return (aa < 3.0) & (q_den > boundary_factor * rhs)
