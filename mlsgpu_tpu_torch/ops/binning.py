"""Splat binning into sorted (octree node, splat) entries (port of
mlsgpu_tpu/ops/binning.py).

Every splat emits up to 8 entries, one per node of its <= 2-per-axis
neighbourhood at the level where its bounding box spans at most 2 nodes per
axis, gated by a conservative sphere/box test (kernels/octree.cl:39-97).
Entries are sorted by node key and the splat rows gathered into entry
order, radius replaced by 1/r^2; a tile's candidates are then `levels`
contiguous segments of the sorted array, found by binary search.

Keys are int64 (the JAX package's uint32 values): INVALID_KEY still sorts
last. The sort is stable, so tie order inside a node differs from the JAX
package's unstable `lax.sort` — only the multiset of splats per node is part
of the contract.

These are the plain versions: on the card the block step runs the key
pass, the sort, the gather and the segments as kernels
(ops/binning_cuda.py, csrc/binning.cu), bit for bit these functions; the
sort is a radix sort whose result is torch.sort(stable=True)'s (its plain
version `radix_sort`, which bin_splats here does not call), and the
segments' kernels first build `node_bounds`' table and gather the segments
from it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from mlsgpu_tpu_torch.ops import morton

INVALID_KEY = 0xFFFFFFFF


def level_offsets(min_shift: int, max_shift: int) -> np.ndarray:
    """Key-space offset per shift so each level's Morton codes are disjoint:
    offsets[s - min_shift] for s in [min_shift, max_shift]."""
    offs = []
    pos = 0
    for s in range(min_shift, max_shift + 1):
        offs.append(pos)
        pos += 8 ** (max_shift - s)
    return np.asarray(offs, dtype=np.int64)


def node_count(min_shift: int, max_shift: int) -> int:
    """K, the node keys of the levels [min_shift, max_shift]: every node
    key is below it (level_offsets' end)."""
    return (8 ** (max_shift - min_shift + 1) - 1) // 7


#: The radix sort's widest digit (csrc/binning.cuh).
SORT_DIGIT_BITS = 8


def sort_digits(min_shift: int, max_shift: int) -> List[Tuple[int, int]]:
    """The radix sort's digits, (shift, bits) for each pass, low digit
    first: every node key is below K = node_count and INVALID_KEY sorts as
    K, so the keys take K.bit_length() bits, cut into SORT_DIGIT_BITS from
    the lowest (the last digit takes what is left): 2 passes at 6 levels,
    3 at 7 (csrc/binning.cuh::bin_sort_plan)."""
    bits = node_count(min_shift, max_shift).bit_length()
    return [(s, min(SORT_DIGIT_BITS, bits - s))
            for s in range(0, bits, SORT_DIGIT_BITS)]


def radix_sort(keys: torch.Tensor, min_shift: int, max_shift: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the card's radix sort of (M,) int64 node keys
    of the shifts [min_shift, max_shift] (each below node_count, or
    INVALID_KEY): INVALID_KEY mapped to K = node_count, a stable sort by
    each digit of sort_digits, low digit first, and the map back. Returns
    (sorted keys, permutation), torch.sort(keys, stable=True)'s."""
    top = node_count(min_shift, max_shift)
    mapped = torch.where(keys == INVALID_KEY, top, keys)
    perm = torch.arange(keys.numel(), dtype=torch.int64, device=keys.device)
    for shift, bits in sort_digits(min_shift, max_shift):
        order = torch.sort((mapped >> shift) & ((1 << bits) - 1),
                           stable=True).indices
        mapped, perm = mapped[order], perm[order]
    return torch.where(mapped == top, INVALID_KEY, mapped), perm


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bits needed for each x in [1, 2^31): the exact integer form of the
    JAX package's `32 - lax.clz(x)`."""
    n = torch.zeros_like(x)
    for k in range(31):
        n += (x >= (1 << k)).to(x.dtype)
    return n


def level_shift(big: torch.Tensor) -> torch.Tensor:
    """Smallest shift at which a span of `big` cells covers <= 2 nodes per
    axis; depends only on the span, so it is invariant to octree alignment
    (kernels/octree.cl:39-55)."""
    bits = bit_length(torch.clamp(big - 1, min=1))
    return torch.where(big > 1, bits, torch.zeros_like(bits))


class BinnedSplats(NamedTuple):
    """Sorted entry arrays for one block."""
    entry_data: torch.Tensor   # (8N, 8) f32 splat rows in entry order, col 3 = 1/r^2
    entry_keys: torch.Tensor   # (8N,) int64 sorted node keys (INVALID_KEY = unused)
    entry_vals: torch.Tensor   # (8N,) int64 splat row per entry (rows ascend in
    # global id, so equal rows <=> same physical splat)


def splat_keys(splats: torch.Tensor, valid: torch.Tensor, cell_origin,
               min_shift: int, max_shift: int) -> torch.Tensor:
    """The key pass of binning: the (8N,) int64 node keys of every splat's
    8 candidate entries, entry c * N + i for corner c of splat i;
    INVALID_KEY where the splat is invalid, misses the node or the node
    lies outside the block."""
    dev = splats.device
    n = splats.shape[0]
    r = splats[:, 3]
    px = [splats[:, a] for a in range(3)]
    org = [int(cell_origin[a]) for a in range(3)]
    lo_g = [torch.floor(px[a] - r).to(torch.int64) for a in range(3)]
    hi_g = [torch.floor(px[a] + r).to(torch.int64) for a in range(3)]
    big = torch.maximum(torch.maximum(hi_g[0] - lo_g[0], hi_g[1] - lo_g[1]),
                        hi_g[2] - lo_g[2])
    shift = torch.clamp(level_shift(big), min_shift, max_shift)
    ilo = [torch.clamp(lo_g[a] - org[a], min=0) >> shift for a in range(3)]

    offs = torch.as_tensor(level_offsets(min_shift, max_shift), device=dev)
    level_offset = offs[shift - min_shift]
    bound = torch.ones_like(shift) << (max_shift - shift)

    r2_conservative = r * r * float(np.float32(1.00001))  # octree.cl:194

    def axis_d2(a, d):
        """Node address on axis a and the squared distance from the splat
        to that node's slab [addr, addr+1) at `shift`."""
        addr = ilo[a] + d
        blo = ((addr << shift) + org[a]).to(torch.float32)
        bhi = (((addr + 1) << shift) + org[a]).to(torch.float32)
        dd = torch.clamp(px[a], min=blo, max=bhi) - px[a]
        return addr, dd * dd

    tabs = [[axis_d2(a, d) for d in (0, 1)] for a in range(3)]
    invalid = torch.full((n,), INVALID_KEY, dtype=torch.int64, device=dev)
    keys = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                (ax, d2x), (ay, d2y), (az, d2z) = (
                    tabs[0][dx], tabs[1][dy], tabs[2][dz])
                isect = (d2x + d2y + d2z) < r2_conservative
                inb = (ax < bound) & (ay < bound) & (az < bound)
                key = level_offset + morton.encode(ax, ay, az)
                keys.append(torch.where(isect & inb & valid, key, invalid))
    return torch.cat(keys)                                       # (8N,)


def entry_rows(splats: torch.Tensor, perm: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gather of binning: from the stable sort's permutation of
    splat_keys' output, (entry_data, entry_vals): each sorted entry's
    splat row (8N, 8) with col 3 = 1/r^2, and its row index (8N,), the
    entry's splat arange(n).repeat(8)[perm]."""
    n = splats.shape[0]
    vals = torch.arange(n, dtype=torch.int64, device=splats.device
                        ).repeat(8)[perm]
    r = splats[:, 3]
    mls_form = splats.clone()
    mls_form[:, 3] = 1.0 / (r * r)
    return mls_form[vals], vals


def bin_splats(splats: torch.Tensor, valid: torch.Tensor,
               cell_origin, min_shift: int, max_shift: int) -> BinnedSplats:
    """Bin splats into sorted (node, splat) entries for one block: the key
    pass, the sort, and the gather of the splat rows into entry order.

    splats: (N, 8) f32 in global grid cell coords, col 3 = radius.
    valid: (N,) bool. cell_origin: the block's first cell (3 ints, x y z).
    Positions stay in the global frame so every block sees bitwise-identical
    splat values (the seam contract)."""
    all_keys = splat_keys(splats, valid, cell_origin, min_shift, max_shift)
    sorted_keys, perm = torch.sort(all_keys, stable=True)
    entry_data, entry_vals = entry_rows(splats, perm)
    return BinnedSplats(entry_data=entry_data, entry_keys=sorted_keys,
                        entry_vals=entry_vals)


def tile_segments(entry_keys: torch.Tensor, min_shift: int, max_shift: int,
                  tiles_per_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For every 8^3-corner tile (enumerated (tz, ty, tx) in C order), the
    sorted-entry segment [start, start + len) of each ancestor octree node.
    Returns (starts, lens), each (T, L) int32."""
    dev = entry_keys.device
    nlev = max_shift - min_shift + 1
    tile_shift = min_shift - 3  # tile coords -> leaf node coords
    t = torch.arange(tiles_per_axis, dtype=torch.int64, device=dev)
    tz, ty, tx = torch.meshgrid(t, t, t, indexing="ij")
    code = morton.encode(tx.reshape(-1), ty.reshape(-1), tz.reshape(-1))
    offs = level_offsets(min_shift, max_shift)
    queries = []
    for li in range(nlev):
        # morton(t) >> 3k == morton(t >> k): ancestor node code by shifting.
        node = (code >> (3 * (tile_shift + li))) + int(offs[li])
        queries.append(node)
        queries.append(node + 1)
    ranks = torch.searchsorted(entry_keys, torch.stack(queries),
                               side="left").to(torch.int32)
    per = ranks.reshape(nlev, 2, -1)
    starts = per[:, 0, :].T.contiguous()
    lens = (per[:, 1, :] - per[:, 0, :]).T.contiguous()
    return starts, lens


def node_bounds(entry_keys: torch.Tensor, min_shift: int,
                max_shift: int) -> torch.Tensor:
    """The first sorted entry of every node key q in [0, K] (K =
    node_count): (K + 1,) int32. Node q's segment is [bounds[q],
    bounds[q + 1]), the one tile_segments finds for it."""
    q = torch.arange(node_count(min_shift, max_shift) + 1, dtype=torch.int64,
                     device=entry_keys.device)
    return torch.searchsorted(entry_keys, q, side="left").to(torch.int32)
