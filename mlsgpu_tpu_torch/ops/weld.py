"""Device vertex welding: sort by key, keep one vertex per key, reindex the
triangles (port of mlsgpu_tpu/ops/weld.py).

Keys are the marching (hi, lo) uint32 pairs, held in int64 tensors. The
external flag is bit 31 of hi, so in the combined 64-bit key it is bit 63:
an unsigned order puts internal vertices first, then externals in key
order. torch sorts int64 as signed, so the sort key flips bit 63 first.
The sort is stable, so the representative of each key is its first
instance by emission index, as in the JAX package; vertices sharing a key
are bitwise identical anyway (the shared edge is interpolated identically
in every incident cell).

Outputs are sized from the true welded count: no padding rows, no caps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_SIGN = torch.iinfo(torch.int64).min  # bit 63


class WeldedMesh(NamedTuple):
    vertices: torch.Tensor   # (nw, 3) f32, internal vertices first
    key_hi: torch.Tensor     # (nw,) int64 u32 values (external flag kept)
    key_lo: torch.Tensor     # (nw,) int64 u32 values
    triangles: torch.Tensor  # (nt, 3) int64 into the welded vertices
    num_vertices: int        # welded vertex count
    first_external: int      # index of the first external vertex
    num_indices: int         # 3 * nt


def weld(vertices: torch.Tensor, key_hi: torch.Tensor, key_lo: torch.Tensor,
         triangles: torch.Tensor) -> WeldedMesh:
    """Weld an unwelded block mesh (marching.generate_mesh's live arrays)."""
    n = vertices.shape[0]
    skey = ((key_hi << 32) | key_lo) ^ _SIGN   # unsigned (hi, lo) order
    s_key, s_idx = torch.sort(skey, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=vertices.device)
    first[1:] = s_key[1:] != s_key[:-1]
    new_id = torch.cumsum(first, 0) - 1
    firstpos = torch.nonzero(first).squeeze(1)
    rep = s_idx[firstpos]
    out_hi = key_hi[rep]
    is_ext = (out_hi >> 31) == 1
    remap = torch.empty_like(new_id)
    remap[s_idx] = new_id                        # inverse permutation
    num_welded = int(firstpos.shape[0])
    return WeldedMesh(vertices=vertices[rep], key_hi=out_hi,
                      key_lo=key_lo[rep], triangles=remap[triangles],
                      num_vertices=num_welded,
                      first_external=int((~is_ext).sum()),
                      num_indices=3 * int(triangles.shape[0]))
