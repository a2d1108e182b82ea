"""Algebraic-sphere MLS fit (port of mlsgpu_tpu/models/sphere.py).

Inputs are corner-centred moments batched over leading axes:
sum_w (...), sum_wp (..., 3), sum_wpp (...), sum_wn (..., 3), sum_wpn (...),
hits (...). Returns the signed distance (positive outside), NaN where
undefined.
"""

from __future__ import annotations

import torch

from mlsgpu_tpu_torch.models.common import (
    FLT_EPSILON, HITS_CUTOFF, boundary_accept, dot3, solve_quadratic)


def sphere_distance(sum_w, sum_wp, sum_wpp, sum_wn, sum_wpn, hits,
                    boundary_factor: float) -> torch.Tensor:
    inv_sum_w = 1.0 / sum_w
    m = sum_wp * inv_sum_w[..., None]
    q_num = sum_wpn - dot3(m, sum_wn)
    q_den = sum_wpp - dot3(m, sum_wp)
    q = q_num / q_den
    # Numeric-instability guard (kernels/mls.cl:217-219)
    unstable = (torch.abs(q_den)
                < (4 * FLT_EPSILON) * hits * torch.abs(sum_wpp))
    q = torch.where(unstable | ~torch.isfinite(q), torch.zeros_like(q), q)

    a = 0.5 * q
    b = (sum_wn - q[..., None] * sum_wp) * inv_sum_w[..., None]
    c = (-a * sum_wpp - dot3(b, sum_wp)) * inv_sum_w
    b2 = dot3(b, b)

    # Project the origin onto the sphere: a_vec = l * b with
    # (a*b2) l^2 + b2 l + c = 0 (kernels/mls.cl:263-267).
    l = solve_quadratic(a * b2, b2, c)
    a_vec = l[..., None] * b

    accept = boundary_accept(q_den, sum_wpp, sum_wp, sum_w, a_vec,
                             boundary_factor)
    f = -dot3(b, a_vec) / torch.sqrt(b2)
    return torch.where(accept & (hits >= HITS_CUTOFF), f,
                       torch.full_like(f, float("nan")))
