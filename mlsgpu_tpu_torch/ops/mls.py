"""MLS signed-distance field: the plain PyTorch versions (port of
mlsgpu_tpu/ops/mls.py).

* `eval_field` is the plain version of the hand-written kernel
  (csrc/mls_field.cu): per-tile candidate gathers, the expanded distance
  form |x|^2 - 2 c.x + |c|^2 with splats re-centred on each tile's global
  origin in one f32 subtraction, weights (1-d)^4 * quality, moment sums and
  the fit. It is uncapped: the gather width of each chunk of tiles is the
  largest tile total in that chunk. It runs where the tensors lie on the
  CPU; on the card the kernel replaces it (ops/mls_cuda.py).
* `canonical_face_field` and `skeleton_point_field` recompute the block's
  face planes and decomposition-edge points so that adjacent blocks agree
  bit for bit (the seam contract; see the JAX module's docstrings).

Seam arithmetic. Every float expression of the face and skeleton passes is
an elementwise op in a fixed order, and their candidate sums are a pairwise
tree over a power-of-two slot axis (`_tree_sum`). Padding such an axis with
zero slots leaves a pairwise tree's value unchanged, so the sums depend
only on the canonical candidate list — not on chunk composition, slot width
or the library's reduction strategy — and two blocks round identically on
the CPU and on the card alike.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from mlsgpu_tpu_torch.models import FIT_MODELS
from mlsgpu_tpu_torch.models.common import RADIUS_CUTOFF, dot3

TILE = 8            # corners per tile axis (the reference's WGS, src/mls.cpp:53)
TILE_CORNERS = TILE ** 3


def corner_offsets(device) -> torch.Tensor:
    """(512, 3) tile-local corner coords, columns (x, y, z), for corner
    index cz*64 + cy*8 + cx."""
    g = np.arange(TILE)
    cz, cy, cx = np.meshgrid(g, g, g, indexing="ij")
    c = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1)
    return torch.as_tensor(c.astype(np.float32), device=device)


def host_ints(v) -> list:
    """A host list of ints from a sequence, array or tensor of coords."""
    return [int(x) for x in (v.tolist() if hasattr(v, "tolist") else v)]


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _tree_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Pairwise sum over `dim`, whose size must be a power of two."""
    while t.shape[dim] > 1:
        h = t.shape[dim] // 2
        t = t.narrow(dim, 0, h) + t.narrow(dim, h, h)
    return t.squeeze(dim)


def _segment_tables(seg_starts: torch.Tensor, seg_lens: torch.Tensor):
    lens = seg_lens.to(torch.int64)
    cum = torch.cumsum(lens, dim=1)
    return seg_starts.to(torch.int64), cum, cum - lens, cum[:, -1]


def _slot_entries(tabs, tids: torch.Tensor, width: int, num_entries: int):
    """Entry index of candidate slot k of each tile in `tids`, walking the
    tile's level segments in order; (C, width) indices and the slot mask."""
    starts, cum, cum0, totals = tabs
    levels = starts.shape[1]
    ks = torch.arange(width, dtype=torch.int64, device=tids.device)
    lvl = (cum[tids][:, None, :] <= ks[None, :, None]).sum(-1)
    lvl = torch.clamp(lvl, max=levels - 1)
    idx = (torch.gather(starts[tids], 1, lvl) + ks[None, :]
           - torch.gather(cum0[tids], 1, lvl))
    ok = ks[None, :] < totals[tids][:, None]
    return torch.clamp(idx, 0, max(num_entries - 1, 0)), ok


def _features(x, nrm):
    """Per-candidate moment features [1, x, |x|^2, n, n.x], shape (..., 9)."""
    x2 = dot3(x, x)
    return torch.cat([torch.ones_like(x2)[..., None], x, x2[..., None], nrm,
                      dot3(nrm, x)[..., None]], dim=-1)


def _weights(corners, x, feats, invr2, qual, ok):
    """Distances and weights of every candidate at every corner.

    corners (C, P, 3), x (C, K, 3) in the same frame; returns the weights
    (C, P, K) and hit counts (C, P). d = (|x|^2 - 2 c.x + |c|^2) / r^2 in
    the kernel's operation order."""
    dotcx = (corners[:, :, None, 0] * x[:, None, :, 0]
             + corners[:, :, None, 1] * x[:, None, :, 1]
             + corners[:, :, None, 2] * x[:, None, :, 2])
    cc = dot3(corners, corners)
    d = (feats[:, None, :, 4] - 2.0 * dotcx + cc[:, :, None]) * invr2[:, None, :]
    keep = (d < RADIUS_CUTOFF) & ok[:, None, :]
    w = 1.0 - d
    w = w * w
    w = w * w
    w = torch.where(keep, w * qual[:, None, :], torch.zeros_like(w))
    return w, keep.sum(-1)


def _fit(m, corners, hits, fit_shape, boundary_factor):
    """Re-centre the moments m (..., 9) on their corners and fit."""
    sum_w = m[..., 0]
    sx = m[..., 1:4]
    sxx = m[..., 4]
    sn = m[..., 5:8]
    snx = m[..., 8]
    sum_wp = sx - corners * sum_w[..., None]
    sum_wpp = sxx - 2.0 * dot3(corners, sx) + dot3(corners, corners) * sum_w
    sum_wpn = snx - dot3(corners, sn)
    return FIT_MODELS[fit_shape](sum_w, sum_wp, sum_wpp, sn, sum_wpn, hits,
                                 boundary_factor)


def _untile(f: torch.Tensor, tpa: int) -> torch.Tensor:
    """(T, 512) per-tile corners -> (B, B, B) field indexed [z, y, x]."""
    b = tpa * TILE
    return (f.reshape(tpa, tpa, tpa, TILE, TILE, TILE)
            .permute(0, 3, 1, 4, 2, 5).reshape(b, b, b))


def eval_field(entry_data: torch.Tensor, seg_starts: torch.Tensor,
               seg_lens: torch.Tensor, cell_origin: Sequence[int],
               tiles_per_axis: int, fit_shape: str, boundary_factor: float,
               tile_chunk: int = 32) -> torch.Tensor:
    """The MLS signed distance on every corner of a block (plain version).

    entry_data (E, 8) f32 sorted entries in global grid coords (col 3 =
    1/r^2); seg_starts/seg_lens (T, L) per-tile level segments; cell_origin
    the block's global cell origin (x, y, z). Returns the (B, B, B) field
    indexed [z, y, x] with B = 8 * tiles_per_axis; NaN = undefined. Empty
    tiles stay NaN."""
    dev = entry_data.device
    tpa = int(tiles_per_axis)
    num_tiles = tpa ** 3
    tabs = _segment_tables(seg_starts, seg_lens)
    totals = tabs[3]
    occ = torch.nonzero(totals > 0).squeeze(1)
    occ_tot = totals[occ].cpu()
    field = torch.full((num_tiles, TILE_CORNERS), float("nan"),
                       dtype=torch.float32, device=dev)
    corners = corner_offsets(dev)[None]
    ox, oy, oz = host_ints(cell_origin)
    for s in range(0, len(occ), tile_chunk):
        tids = occ[s:s + tile_chunk]
        width = int(occ_tot[s:s + tile_chunk].max())
        idx, ok = _slot_entries(tabs, tids, width, entry_data.shape[0])
        data = entry_data[idx]                                  # (C, K, 8)
        # Global tile origins; integer coords <= 2^21 are exact in f32.
        org = torch.stack([(tids % tpa) * TILE + ox,
                           ((tids // tpa) % tpa) * TILE + oy,
                           (tids // (tpa * tpa)) * TILE + oz],
                          dim=1).to(torch.float32)
        x = data[..., 0:3] - org[:, None, :]
        feats = _features(x, data[..., 4:7])
        w, hits = _weights(corners.expand(len(tids), -1, -1), x, feats,
                           data[..., 3], data[..., 7], ok)
        m = torch.bmm(w, feats)                                 # (C, 512, 9)
        field[tids] = _fit(m, corners, hits, fit_shape, boundary_factor)
    return _untile(field, tpa)


def candidate_work(entry_data: torch.Tensor, seg_starts: torch.Tensor,
                   seg_lens: torch.Tensor, cell_origin: Sequence[int],
                   tiles_per_axis: int, tile_chunk: int = 32
                   ) -> Tuple[int, int, int]:
    """What `eval_field` of these inputs has to compute, the work measure of
    the field kernel's bound: (corner-candidate pairs; the pairs within
    reach, those whose candidate passes the box test of its corner's 8x4x4
    box, as csrc/mls_field.cu writes it, up to rounding; the pairs with
    d < 0.99, counted with the plain version's own distance)."""
    tpa = int(tiles_per_axis)
    tabs = _segment_tables(seg_starts, seg_lens)
    totals = tabs[3]
    occ = torch.nonzero(totals > 0).squeeze(1)
    occ_tot = totals[occ].cpu()
    corners = corner_offsets(entry_data.device)[None]
    ox, oy, oz = host_ints(cell_origin)
    hits = reached = 0
    for s in range(0, len(occ), tile_chunk):
        tids = occ[s:s + tile_chunk]
        width = int(occ_tot[s:s + tile_chunk].max())
        idx, ok = _slot_entries(tabs, tids, width, entry_data.shape[0])
        data = entry_data[idx]
        org = torch.stack([(tids % tpa) * TILE + ox,
                           ((tids // tpa) % tpa) * TILE + oy,
                           (tids // (tpa * tpa)) * TILE + oz],
                          dim=1).to(torch.float32)
        x = data[..., 0:3] - org[:, None, :]
        feats = _features(x, data[..., 4:7])
        _, h = _weights(corners.expand(len(tids), -1, -1), x, feats,
                        data[..., 3], data[..., 7], ok)
        hits += int(h.sum())
        slack = 4e-6 * (feats[..., 4] + 150.0)
        zero = torch.zeros_like(slack)
        ex = torch.maximum(torch.maximum(-x[..., 0], x[..., 0] - 7.0), zero)
        for y0 in (0.0, 4.0):
            ey = torch.maximum(torch.maximum(y0 - x[..., 1],
                                             x[..., 1] - (y0 + 3.0)), zero)
            for z0 in (0.0, 4.0):
                ez = torch.maximum(torch.maximum(z0 - x[..., 2],
                                                 x[..., 2] - (z0 + 3.0)), zero)
                dist2 = ex * ex + ey * ey + ez * ez
                reach = ~((dist2 - slack) * data[..., 3] >= RADIUS_CUTOFF)
                reached += int((reach & ok).sum()) * (TILE_CORNERS // 4)
    return int(occ_tot.sum()) * TILE_CORNERS, reached, hits


def _canonical_moments(entry_data, cols_idx, sval, frame, corners,
                       fit_shape, boundary_factor):
    """Moments and fit of the canonical candidate lists: cols_idx/sval
    (C, K) with K a power of two, frame (C, 3) the exact integer anchor,
    corners (C, P, 3) in that frame. Sums are a pairwise tree over K."""
    cols = entry_data[cols_idx]                                 # (C, K, 8)
    x = cols[..., 0:3] - frame[:, None, :]
    feats = _features(x, cols[..., 4:7])
    w, hits = _weights(corners, x, feats, cols[..., 3], cols[..., 7], sval)
    m = _tree_sum(w[..., None] * feats[:, None, :, :], dim=2)  # (C, P, 9)
    return _fit(m, corners, hits, fit_shape, boundary_factor)


def _take_slots(idx: torch.Tensor, ok: torch.Tensor, width: int):
    """The first `width` slots of each row, padded with empty slots."""
    have = idx.shape[1]
    if have >= width:
        return idx[:, :width], ok[:, :width]
    pad = width - have
    return (torch.cat([idx, idx.new_zeros(idx.shape[0], pad)], dim=1),
            torch.cat([ok, ok.new_zeros(ok.shape[0], pad)], dim=1))


def canonical_face_field(field: torch.Tensor, entry_data: torch.Tensor,
                         entry_vals: torch.Tensor, seg_starts: torch.Tensor,
                         seg_lens: torch.Tensor, cell_origin: Sequence[int],
                         region_cells: Sequence[int], tiles_per_axis: int,
                         fit_shape: str, boundary_factor: float,
                         row_chunk: int = 32) -> torch.Tensor:
    """Recompute the six face corner planes of `field` (in place) on
    patches of the global 8-corner grid, so adjacent blocks agree bitwise
    on shared corners. Each patch's candidates are the union of its <= 4
    covering tiles' lists, filtered by an exact splat-to-rectangle test,
    deduplicated by splat identity and ordered by it; all arithmetic runs
    in the patch's multiple-of-8 global frame. Returns `field`."""
    dev = field.device
    tpa = int(tiles_per_axis)
    num_entries = entry_data.shape[0]
    tabs = _segment_tables(seg_starts, seg_lens)
    totals = tabs[3]
    org = np.asarray(host_ints(cell_origin), np.int64)
    rc = np.asarray(host_ints(region_cells), np.int64)

    # Static patch rows: 6 faces x (tpa+1)^2 global 8-grid patches.
    n_p = tpa + 1
    f2 = n_p * n_p
    rows = np.arange(6 * f2)
    face = rows // f2
    axis_a = face // 2                      # 0=x, 1=y, 2=z
    side = face % 2
    axis_b = (axis_a + 1) % 3
    axis_c = (axis_a + 2) % 3
    plane_g = org[axis_a] + np.where(side == 1, rc[axis_a], 0)
    base_a = (plane_g // 8) * 8
    base_b = (org[axis_b] // 8 + (rows % f2) // n_p) * 8
    base_c = (org[axis_c] // 8 + rows % n_p) * 8

    # Covering tiles: one layer on axis a, a 2x2 in-plane neighbourhood.
    layer_a = np.where(side == 1, rc[axis_a] // TILE, 0)
    lo_b = base_b - org[axis_b]
    lo_c = base_c - org[axis_c]
    tb = [np.clip(lo_b // TILE, 0, tpa - 1),
          np.clip((lo_b + 7) // TILE, 0, tpa - 1)]
    tc = [np.clip(lo_c // TILE, 0, tpa - 1),
          np.clip((lo_c + 7) // TILE, 0, tpa - 1)]
    r_i = np.arange(len(rows))

    def tile_id(tbv, tcv):
        t = np.zeros((len(rows), 3), np.int64)
        t[r_i, axis_a] = layer_a
        t[r_i, axis_b] = tbv
        t[r_i, axis_c] = tcv
        return (t[:, 2] * tpa + t[:, 1]) * tpa + t[:, 0]

    tid4 = torch.as_tensor(np.stack([tile_id(tb[0], tc[0]),
                                     tile_id(tb[0], tc[1]),
                                     tile_id(tb[1], tc[0]),
                                     tile_id(tb[1], tc[1])], axis=1),
                           device=dev)
    row_tot = totals[tid4].max(dim=1).values
    occ = torch.nonzero(row_tot > 0).squeeze(1)
    occ_rows = occ.cpu().numpy()
    tile_tot = row_tot[occ].cpu()

    def on_dev(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    g8 = torch.arange(TILE, device=dev)
    fb = g8.repeat_interleave(TILE).to(torch.float32)          # (64,)
    fc = g8.repeat(TILE).to(torch.float32)
    out = torch.full((len(rows), 64), float("nan"), dtype=torch.float32,
                     device=dev)
    cut = float(np.float32(RADIUS_CUTOFF))

    for s in range(0, len(occ_rows), row_chunk):
        rsel = occ_rows[s:s + row_chunk]
        ridx = occ[s:s + row_chunk]
        c = len(rsel)
        kt = int(tile_tot[s:s + row_chunk].max())
        idx, ok = _slot_entries(tabs, tid4[ridx].reshape(-1), kt, num_entries)
        idx = idx.reshape(c, 4 * kt)
        ok = ok.reshape(c, 4 * kt)
        pre = entry_data[idx][..., 0:4]                        # (C, 4K, 4)
        ids = entry_vals[idx]

        # Exact splat-to-patch-rectangle filter in global f32 coords.
        aa, bb, cc = on_dev(axis_a[rsel]), on_dev(axis_b[rsel]), on_dev(axis_c[rsel])

        def coord(ax):
            return torch.gather(pre[..., 0:3], 2,
                                ax[:, None, None].expand(c, pre.shape[1], 1))[..., 0]

        da = coord(aa) - on_dev(plane_g[rsel], torch.float32)[:, None]
        b0 = on_dev(base_b[rsel], torch.float32)[:, None]
        c0 = on_dev(base_c[rsel], torch.float32)[:, None]
        pb, pc = coord(bb), coord(cc)
        db = torch.clamp(torch.maximum(b0 - pb, pb - (b0 + 7.0)), min=0.0)
        dc = torch.clamp(torch.maximum(c0 - pc, pc - (c0 + 7.0)), min=0.0)
        rect2 = da * da + db * db + dc * dc
        valid = ok & (rect2 * pre[..., 3] < cut)

        # Order by (valid first, splat identity), drop duplicate splats (a
        # splat can sit in several covering tiles' lists), then move the
        # kept ones to the front stably: identical physical splats at
        # identical slot positions in every block.
        key = (~valid).to(torch.int64) * (1 << 40) + ids
        order = torch.sort(key, dim=1, stable=True).indices
        ids1 = torch.gather(ids, 1, order)
        idx1 = torch.gather(idx, 1, order)
        v1 = torch.gather(valid, 1, order)
        dup = torch.zeros_like(v1)
        dup[:, 1:] = v1[:, 1:] & v1[:, :-1] & (ids1[:, 1:] == ids1[:, :-1])
        v2 = v1 & ~dup
        order2 = torch.sort((~v2).to(torch.uint8), dim=1, stable=True).indices
        kept = int(v2.sum(dim=1).max())
        cols_idx, sval = _take_slots(torch.gather(idx1, 1, order2),
                                     torch.gather(v2, 1, order2), _pow2(kept))

        # Patch frame (multiple-of-8 global anchor) and the 8x8 in-plane
        # corners at the plane, assembled from one-hot axis masks: integer
        # values times 0/1 on disjoint axes are exact in f32.
        ar3 = torch.arange(3, device=dev)[None, :]
        oh_a = (ar3 == aa[:, None]).to(torch.float32)          # (C, 3)
        oh_b = (ar3 == bb[:, None]).to(torch.float32)
        oh_c = (ar3 == cc[:, None]).to(torch.float32)
        frame = (on_dev(base_a[rsel], torch.float32)[:, None] * oh_a
                 + b0 * oh_b + c0 * oh_c)
        pa = on_dev(plane_g[rsel] - base_a[rsel], torch.float32)
        corners = (pa[:, None, None] * oh_a[:, None, :]
                   + fb[None, :, None] * oh_b[:, None, :]
                   + fc[None, :, None] * oh_c[:, None, :])     # (C, 64, 3)
        out[ridx] = _canonical_moments(entry_data, cols_idx, sval, frame,
                                       corners, fit_shape, boundary_factor)

    # Write each face's patch image over its plane. Sequential face order
    # (x-, x+, y-, y+, z-, z+) makes the edge-overlap winner the highest
    # axis in every block.
    bdim = field.shape[0]
    side_np = TILE * n_p
    for f in range(6):
        a, s_ = f // 2, f % 2
        b_ax, c_ax = (a + 1) % 3, (a + 2) % 3
        pface = (out[f * f2:(f + 1) * f2].reshape(n_p, n_p, TILE, TILE)
                 .permute(0, 2, 1, 3).reshape(side_np, side_np))
        la = int(rc[a]) if s_ == 1 else 0
        ob = int(org[b_ax] - (org[b_ax] // 8) * 8)
        oc = int(org[c_ax] - (org[c_ax] // 8) * 8)
        psl = pface[ob:ob + bdim, oc:oc + bdim]
        if a == 0:    # plane x = la; psl[y, z] -> field[z, y, la]
            field[:, :, la] = psl.T
        elif a == 1:  # plane y = la; psl[z, x] -> field[z, la, x]
            field[:, la, :] = psl
        else:         # plane z = la; psl[x, y] -> field[la, y, x]
            field[la, :, :] = psl.T
    return field


def skeleton_point_field(field: torch.Tensor, entry_data: torch.Tensor,
                         entry_vals: torch.Tensor, seg_starts: torch.Tensor,
                         seg_lens: torch.Tensor, cell_origin: Sequence[int],
                         points: torch.Tensor, tiles_per_axis: int,
                         fit_shape: str, boundary_factor: float,
                         point_chunk: int = 64) -> torch.Tensor:
    """Recompute `field` (in place) at decomposition edge-skeleton points so
    every block containing such a point computes a bitwise-identical value:
    candidates from one tile whose closed box holds the point, the strict
    positive-weight filter, ascending stream order, arithmetic in the frame
    of the global 8-aligned cube holding the point. points: (P, 3) int
    global corner coords (x, y, z); rows with a negative coordinate or
    outside the block are ignored. A point whose tile holds no candidates
    becomes NaN. Returns `field`."""
    dev = field.device
    tpa = int(tiles_per_axis)
    bdim = field.shape[0]
    if points is None or points.shape[0] == 0:
        return field
    num_entries = entry_data.shape[0]
    tabs = _segment_tables(seg_starts, seg_lens)
    totals = tabs[3]
    pts = points.to(device=dev, dtype=torch.int64)
    org = torch.as_tensor(host_ints(cell_origin), dtype=torch.int64,
                          device=dev)
    lp = pts - org[None, :]
    t = torch.clamp(torch.div(lp, TILE, rounding_mode="floor"), 0, tpa - 1)
    tid = (t[:, 2] * tpa + t[:, 1]) * tpa + t[:, 0]
    inside = (pts >= 0).all(dim=1) & (lp >= 0).all(dim=1) & (lp < bdim).all(dim=1)
    empty = lp[inside & (totals[tid] == 0)]
    field[empty[:, 2], empty[:, 1], empty[:, 0]] = float("nan")
    occ = torch.nonzero(inside & (totals[tid] > 0)).squeeze(1)
    occ_tot = totals[tid[occ]].cpu()
    cut = float(np.float32(RADIUS_CUTOFF))
    big = torch.iinfo(torch.int64).max

    for s in range(0, len(occ), point_chunk):
        pidx = occ[s:s + point_chunk]
        tids = tid[pidx]
        width = int(occ_tot[s:s + point_chunk].max())
        idx, ok = _slot_entries(tabs, tids, width, num_entries)
        data = entry_data[idx]                                  # (C, K, 8)
        pg = pts[pidx].to(torch.float32)
        dx = data[..., 0:3] - pg[:, None, :]
        valid = ok & (dot3(dx, dx) * data[..., 3] < cut)
        # Canonical order: ascending stream order (a splat sits at most
        # once in one tile's chain).
        key = torch.where(valid, entry_vals[idx], torch.full_like(idx, big))
        order = torch.sort(key, dim=1, stable=True).indices
        kept = int(valid.sum(dim=1).max())
        cols_idx, sval = _take_slots(torch.gather(idx, 1, order),
                                     torch.gather(valid, 1, order),
                                     _pow2(kept))
        base = torch.div(pts[pidx], TILE, rounding_mode="floor") * TILE
        corner = (pts[pidx] - base).to(torch.float32)[:, None, :]
        vals = _canonical_moments(entry_data, cols_idx, sval,
                                  base.to(torch.float32), corner,
                                  fit_shape, boundary_factor)
        lq = lp[pidx]
        field[lq[:, 2], lq[:, 1], lq[:, 0]] = vals[:, 0]
    return field
