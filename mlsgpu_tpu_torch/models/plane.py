"""Weighted-plane MLS fit (port of mlsgpu_tpu/models/plane.py). Same moment
inputs as sphere_distance; sum_wpn is accepted and ignored."""

from __future__ import annotations

import torch

from mlsgpu_tpu_torch.models.common import HITS_CUTOFF, boundary_accept, dot3


def plane_distance(sum_w, sum_wp, sum_wpp, sum_wn, sum_wpn, hits,
                   boundary_factor: float) -> torch.Tensor:
    del sum_wpn
    mean = sum_wp / sum_w[..., None]
    norm = torch.sqrt(dot3(sum_wn, sum_wn))
    normal = sum_wn / norm[..., None]
    dist = -dot3(normal, mean)

    a_vec = normal * (-dist[..., None])
    q_den = sum_wpp - dot3(mean, sum_wp)
    accept = boundary_accept(q_den, sum_wpp, sum_wp, sum_w, a_vec,
                             boundary_factor)
    return torch.where(accept & (hits >= HITS_CUTOFF), dist,
                       torch.full_like(dist, float("nan")))
