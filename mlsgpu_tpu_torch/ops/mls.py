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
  bit for bit (the seam contract; see the JAX module's docstrings). Each
  is three steps: the rows' or points' preparation (`face_rows`,
  `skeleton_points`), the moments (`face_moments`, `skeleton_moments`),
  and the fit and write (`fit_faces`, `fit_points`). Together they are
  the plain versions of the seam kernels (csrc/seam_moments.cu), which
  ops/seam_cuda.py launches on the card, one launch a pass, and which
  equal them bit for bit.

Seam arithmetic. A face or skeleton corner's value depends only on the set
of splats with positive weight at that corner (those within reach, d <
RADIUS_CUTOFF), taken in global stream order: every block that holds the
corner computes it bitwise alike. Every block has all of them, since a
splat that reaches a corner of a block's tile is binned into that tile
(the conservative node test of ops/binning.py) and each pass reads the
tiles that hold its corner. The lists the passes gather are wider than
that set and depend on the block: a face patch straddles a block's
in-plane edge wherever the block origin is not a multiple of 8, and its
rectangle filter then keeps splats that reach the patch only outside the
block, which one neighbour lists and the other does not. Such a splat
weighs exactly 0 at every corner of the block, but a zero in the middle of
a list moves the later slots of a pairwise tree and so the rounding. So
`_canonical_sums` moves each corner's candidates of positive weight to
the front of its row, in the row's stream order, before it sums. Every
float expression of both passes is an elementwise op in a fixed order, and
each sum is a pairwise tree over a power-of-two slot axis (`_tree_sum`),
which zero slots appended at the end leave unchanged: the sums depend
neither on the list's width nor on chunk composition nor on the library's
reduction strategy, and two blocks round identically on the CPU and on the
card alike. The kernels build the same tree on a warp (its residue classes
of rank a lane each, shuffles, a stack of the classes), so they equal
these versions value for value. Stream
order is the block's splat order, which the streamer keeps the same for
the splats two blocks share (streamer.load_bucket).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from mlsgpu_tpu_torch.models import FIT_MODELS
from mlsgpu_tpu_torch.models.common import HITS_CUTOFF, RADIUS_CUTOFF, dot3

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
    """Pairwise sum over `dim`, whose size must be a power of two: slot i
    with slot i + size/2 first, then the halves again. With G = size / 32
    it is the halves tree over the G residue classes of slot mod G, each
    class the halves tree of its 32 slots in order, which is how the seam
    kernels build it on a warp (csrc/seam_moments.cu)."""
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


def _canonical_sums(entry_data, cols_idx, sval, frame, corners):
    """Moments and hit counts of candidate lists in stream order: cols_idx/
    sval (C, K) with K a power of two, frame (C, 3) the exact integer
    anchor, corners (C, P, 3) in that frame. Each corner sums over exactly
    the candidates of nonzero weight there, moved to the front of the slot
    axis in the row's order by a stable sort, as a pairwise tree over K; its
    hit count is of the candidates within reach, the same set for positive
    quality. So a corner's value depends only on that set and its stream
    order, not on what else the row lists. Returns (moments (C, P, 9),
    hits (C, P) int32)."""
    cols = entry_data[cols_idx]                                 # (C, K, 8)
    x = cols[..., 0:3] - frame[:, None, :]
    feats = _features(x, cols[..., 4:7])
    w, hits = _weights(corners, x, feats, cols[..., 3], cols[..., 7], sval)
    order = torch.sort((w == 0).to(torch.uint8), dim=2, stable=True).indices
    rows = torch.arange(w.shape[0], device=w.device)[:, None, None]
    wf = feats[rows, order]                                     # (C, P, K, 9)
    wf.mul_(torch.gather(w, 2, order)[..., None])
    return _tree_sum(wf, dim=2), hits.to(torch.int32)           # (C, P, 9)


def _take_slots(idx: torch.Tensor, ok: torch.Tensor, width: int):
    """The first `width` slots of each row, padded with empty slots."""
    have = idx.shape[1]
    if have >= width:
        return idx[:, :width], ok[:, :width]
    pad = width - have
    return (torch.cat([idx, idx.new_zeros(idx.shape[0], pad)], dim=1),
            torch.cat([ok, ok.new_zeros(ok.shape[0], pad)], dim=1))


# Columns of the face pass's patch rows (`face_rows`).
ROW_AXIS, ROW_PLANE, ROW_BASE_A, ROW_BASE_B, ROW_BASE_C, ROW_TILES = range(6)
ROW_COLS = ROW_TILES + 4


def face_rows(cell_origin: Sequence[int], region_cells: Sequence[int],
              tiles_per_axis: int) -> np.ndarray:
    """The face pass's static patch rows: 6 faces x (tpa+1)^2 patches of
    the global 8-corner grid, (R, ROW_COLS) int64 on the host. Columns:
    the face's axis a (0 = x, 1 = y, 2 = z; the in-plane axes b and c
    follow it cyclically), the face's global plane on a, the patch's
    multiple-of-8 anchor on a, b and c, and its <= 4 covering tiles (one
    layer on a, a 2x2 in-plane neighbourhood; repeated where clipped)."""
    tpa = int(tiles_per_axis)
    org = np.asarray(host_ints(cell_origin), np.int64)
    rc = np.asarray(host_ints(region_cells), np.int64)
    n_p = tpa + 1
    f2 = n_p * n_p
    rows = np.arange(6 * f2)
    face = rows // f2
    axis_a = face // 2
    side = face % 2
    axis_b = (axis_a + 1) % 3
    axis_c = (axis_a + 2) % 3
    plane_g = org[axis_a] + np.where(side == 1, rc[axis_a], 0)
    base_a = (plane_g // 8) * 8
    base_b = (org[axis_b] // 8 + (rows % f2) // n_p) * 8
    base_c = (org[axis_c] // 8 + rows % n_p) * 8

    layer_a = np.where(side == 1, rc[axis_a] // TILE, 0)
    lo_b = base_b - org[axis_b]
    lo_c = base_c - org[axis_c]
    tb = [np.clip(lo_b // TILE, 0, tpa - 1),
          np.clip((lo_b + 7) // TILE, 0, tpa - 1)]
    tc = [np.clip(lo_c // TILE, 0, tpa - 1),
          np.clip((lo_c + 7) // TILE, 0, tpa - 1)]

    def tile_id(tbv, tcv):
        t = np.zeros((len(rows), 3), np.int64)
        t[rows, axis_a] = layer_a
        t[rows, axis_b] = tbv
        t[rows, axis_c] = tcv
        return (t[:, 2] * tpa + t[:, 1]) * tpa + t[:, 0]

    return np.stack([axis_a, plane_g, base_a, base_b, base_c,
                     tile_id(tb[0], tc[0]), tile_id(tb[0], tc[1]),
                     tile_id(tb[1], tc[0]), tile_id(tb[1], tc[1])], axis=1)


def face_frames(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each patch row's frame (its multiple-of-8 global anchor, (R, 3) f32)
    and its 8x8 in-plane corners at the plane in that frame ((R, 64, 3)
    f32; corner k at b = k // 8, c = k % 8), assembled from one-hot axis
    masks: integer values times 0/1 on disjoint axes are exact in f32."""
    dev = rows.device
    aa = rows[:, ROW_AXIS]
    ar3 = torch.arange(3, device=dev)[None, :]
    oh_a = (ar3 == aa[:, None]).to(torch.float32)              # (R, 3)
    oh_b = (ar3 == ((aa + 1) % 3)[:, None]).to(torch.float32)
    oh_c = (ar3 == ((aa + 2) % 3)[:, None]).to(torch.float32)
    frame = (rows[:, ROW_BASE_A].to(torch.float32)[:, None] * oh_a
             + rows[:, ROW_BASE_B].to(torch.float32)[:, None] * oh_b
             + rows[:, ROW_BASE_C].to(torch.float32)[:, None] * oh_c)
    g8 = torch.arange(TILE, device=dev)
    fb = g8.repeat_interleave(TILE).to(torch.float32)          # (64,)
    fc = g8.repeat(TILE).to(torch.float32)
    pa = (rows[:, ROW_PLANE] - rows[:, ROW_BASE_A]).to(torch.float32)
    corners = (pa[:, None, None] * oh_a[:, None, :]
               + fb[None, :, None] * oh_b[:, None, :]
               + fc[None, :, None] * oh_c[:, None, :])         # (R, 64, 3)
    return frame, corners


def _face_chunks(entry_data, entry_vals, seg_starts, seg_lens, rows,
                 row_chunk):
    """The occupied patch rows `row_chunk` at a time: per chunk (row ids,
    each row's candidate entries ordered by (kept first, splat identity),
    the kept mask). A row's candidates are the union of its covering tiles'
    lists; it keeps those that pass an exact splat-to-rectangle test, once
    per splat identity."""
    num_entries = entry_data.shape[0]
    tabs = _segment_tables(seg_starts, seg_lens)
    totals = tabs[3]
    tid4 = rows[:, ROW_TILES:ROW_TILES + 4]
    row_tot = totals[tid4].max(dim=1).values
    occ = torch.nonzero(row_tot > 0).squeeze(1)
    tile_tot = row_tot[occ].cpu()
    cut = float(np.float32(RADIUS_CUTOFF))

    for s in range(0, len(occ), row_chunk):
        ridx = occ[s:s + row_chunk]
        c = len(ridx)
        kt = int(tile_tot[s:s + row_chunk].max())
        idx, ok = _slot_entries(tabs, tid4[ridx].reshape(-1), kt, num_entries)
        idx = idx.reshape(c, 4 * kt)
        ok = ok.reshape(c, 4 * kt)
        pre = entry_data[idx][..., 0:4]                        # (C, 4K, 4)
        ids = entry_vals[idx]

        # Exact splat-to-patch-rectangle filter in global f32 coords.
        r = rows[ridx]
        aa = r[:, ROW_AXIS]

        def coord(ax):
            return torch.gather(pre[..., 0:3], 2,
                                ax[:, None, None].expand(c, pre.shape[1], 1))[..., 0]

        da = coord(aa) - r[:, ROW_PLANE].to(torch.float32)[:, None]
        b0 = r[:, ROW_BASE_B].to(torch.float32)[:, None]
        c0 = r[:, ROW_BASE_C].to(torch.float32)[:, None]
        pb, pc = coord((aa + 1) % 3), coord((aa + 2) % 3)
        db = torch.clamp(torch.maximum(b0 - pb, pb - (b0 + 7.0)), min=0.0)
        dc = torch.clamp(torch.maximum(c0 - pc, pc - (c0 + 7.0)), min=0.0)
        rect2 = da * da + db * db + dc * dc
        valid = ok & (rect2 * pre[..., 3] < cut)

        # Order by (valid first, splat identity) and drop duplicate splats
        # (a splat can sit in several covering tiles' lists).
        key = (~valid).to(torch.int64) * (1 << 40) + ids
        order = torch.sort(key, dim=1, stable=True).indices
        ids1 = torch.gather(ids, 1, order)
        v1 = torch.gather(valid, 1, order)
        dup = torch.zeros_like(v1)
        dup[:, 1:] = v1[:, 1:] & v1[:, :-1] & (ids1[:, 1:] == ids1[:, :-1])
        yield ridx, torch.gather(idx, 1, order), v1 & ~dup


def face_moments(entry_data: torch.Tensor, entry_vals: torch.Tensor,
                 seg_starts: torch.Tensor, seg_lens: torch.Tensor,
                 rows: torch.Tensor, row_chunk: int = 32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The moments step of the face pass (plain version of the face kernel,
    csrc/seam_moments.cu): (R, 64, 9) f32 moments and (R, 64) int32 hit
    counts of every patch row of `rows` (face_rows on the device), zero on
    rows whose covering tiles are empty. Each row's kept candidates
    (_face_chunks) in splat identity order, moved to the front stably:
    identical physical splats at identical slot positions in every block;
    all arithmetic runs in the patch's frame."""
    dev = entry_data.device
    frame_all, corners_all = face_frames(rows)
    moments = torch.zeros((rows.shape[0], 64, 9), dtype=torch.float32,
                          device=dev)
    hits = torch.zeros((rows.shape[0], 64), dtype=torch.int32, device=dev)
    for ridx, idx1, v2 in _face_chunks(entry_data, entry_vals, seg_starts,
                                       seg_lens, rows, row_chunk):
        order2 = torch.sort((~v2).to(torch.uint8), dim=1, stable=True).indices
        kept = int(v2.sum(dim=1).max())
        cols_idx, sval = _take_slots(torch.gather(idx1, 1, order2),
                                     torch.gather(v2, 1, order2), _pow2(kept))
        moments[ridx], hits[ridx] = _canonical_sums(
            entry_data, cols_idx, sval, frame_all[ridx], corners_all[ridx])
    return moments, hits


def face_work(entry_data: torch.Tensor, entry_vals: torch.Tensor,
              seg_starts: torch.Tensor, seg_lens: torch.Tensor,
              rows: torch.Tensor, cell_origin: Sequence[int],
              region_cells: Sequence[int], tiles_per_axis: int
              ) -> Tuple[int, int, int, int]:
    """What the face pass of these inputs has to compute, the work measure
    of the face kernel's bound: (candidate slots listed, summed over the
    rows' distinct covering tiles; candidates kept, after the filter and
    the deduplication, each summed at all 64 corners of its row; field
    corners written, those of the six planes; of those, the corners with
    HITS_CUTOFF hits or more, which need the fit)."""
    totals = seg_lens.to(torch.int64).sum(dim=1)
    tid4 = rows[:, ROW_TILES:ROW_TILES + 4]
    distinct = torch.ones_like(tid4, dtype=torch.bool)
    for j in range(1, 4):
        distinct[:, j] = (tid4[:, j:j + 1] != tid4[:, :j]).all(dim=1)
    listed = int((totals[tid4] * distinct).sum())
    kept = sum(int(v2.sum()) for _, _, v2 in _face_chunks(
        entry_data, entry_vals, seg_starts, seg_lens, rows, 32))
    # which patch corner each field corner of the planes takes
    b = TILE * int(tiles_per_axis)
    at = torch.full((b, b, b), -1.0, dtype=torch.float32,
                    device=entry_data.device)
    index = torch.arange(rows.shape[0] * 64, device=entry_data.device)
    write_faces(at, index.reshape(-1, 64).to(torch.float32), cell_origin,
                region_cells, tiles_per_axis)
    taken = at[at >= 0].to(torch.int64)
    _, hits = face_moments(entry_data, entry_vals, seg_starts, seg_lens,
                           rows)
    fitted = int((hits.reshape(-1)[taken] >= HITS_CUTOFF).sum())
    return listed, kept, int(taken.numel()), fitted


def write_faces(field: torch.Tensor, out: torch.Tensor,
                cell_origin: Sequence[int], region_cells: Sequence[int],
                tiles_per_axis: int) -> torch.Tensor:
    """Write each face's patch image `out` (R, 64) over its plane of
    `field` (in place). Sequential face order (x-, x+, y-, y+, z-, z+)
    makes the edge-overlap winner the highest axis in every block."""
    org = host_ints(cell_origin)
    rc = host_ints(region_cells)
    n_p = int(tiles_per_axis) + 1
    f2 = n_p * n_p
    bdim = field.shape[0]
    side_np = TILE * n_p
    for f in range(6):
        a, s_ = f // 2, f % 2
        b_ax, c_ax = (a + 1) % 3, (a + 2) % 3
        pface = (out[f * f2:(f + 1) * f2].reshape(n_p, n_p, TILE, TILE)
                 .permute(0, 2, 1, 3).reshape(side_np, side_np))
        la = rc[a] if s_ == 1 else 0
        ob = org[b_ax] - (org[b_ax] // 8) * 8
        oc = org[c_ax] - (org[c_ax] // 8) * 8
        psl = pface[ob:ob + bdim, oc:oc + bdim]
        if a == 0:    # plane x = la; psl[y, z] -> field[z, y, la]
            field[:, :, la] = psl.T
        elif a == 1:  # plane y = la; psl[z, x] -> field[z, la, x]
            field[:, la, :] = psl
        else:         # plane z = la; psl[x, y] -> field[la, y, x]
            field[la, :, :] = psl.T
    return field


def rows_on(rows: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host rows on `dev` in one copy; from pinned memory, without waiting
    for the card, where `dev` is a CUDA device (a copy from pageable host
    memory waits for it: PERF.md §5, the step's trace)."""
    t = torch.as_tensor(rows)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def canonical_face_field(field: torch.Tensor, entry_data: torch.Tensor,
                         entry_vals: torch.Tensor, seg_starts: torch.Tensor,
                         seg_lens: torch.Tensor, cell_origin: Sequence[int],
                         region_cells: Sequence[int], tiles_per_axis: int,
                         fit_shape: str, boundary_factor: float,
                         row_chunk: int = 32) -> torch.Tensor:
    """Recompute the six face corner planes of `field` (in place) on
    patches of the global 8-corner grid, so adjacent blocks agree bitwise
    on shared corners (plain version): face_rows, face_moments, the fit,
    write_faces. Returns `field`."""
    rows = rows_on(face_rows(cell_origin, region_cells, tiles_per_axis),
                   field.device)
    m, hits = face_moments(entry_data, entry_vals, seg_starts, seg_lens,
                           rows, row_chunk)
    return fit_faces(field, m, hits, rows, cell_origin, region_cells,
                     tiles_per_axis, fit_shape, boundary_factor)


def fit_faces(field, m, hits, rows, cell_origin, region_cells,
              tiles_per_axis, fit_shape, boundary_factor) -> torch.Tensor:
    """The fit of every patch corner from its moments, then write_faces:
    the plain face pass's last step (the face kernel fits and writes in
    its own epilogue). Rows without candidates fit to NaN (no hits)."""
    _, corners = face_frames(rows)
    out = _fit(m, corners, hits, fit_shape, boundary_factor)
    return write_faces(field, out, cell_origin, region_cells, tiles_per_axis)


def skeleton_points(points: torch.Tensor, cell_origin: Sequence[int],
                    tiles_per_axis: int, bdim: int):
    """The skeleton pass's point preparation: (points (P, 3) int64 global
    corners, their block-local coords (P, 3), the tile holding each (P,),
    and whether each lies inside the block (P,) bool; a point with a
    negative coordinate counts as outside)."""
    tpa = int(tiles_per_axis)
    pts = points.to(dtype=torch.int64)
    # the origin as scalars: no host-to-device copy, which would wait for
    # the card
    lp = torch.stack([pts[:, a] - o for a, o in
                      enumerate(host_ints(cell_origin))], dim=1)
    t = torch.clamp(torch.div(lp, TILE, rounding_mode="floor"), 0, tpa - 1)
    tid = (t[:, 2] * tpa + t[:, 1]) * tpa + t[:, 0]
    inside = ((pts >= 0).all(dim=1) & (lp >= 0).all(dim=1)
              & (lp < bdim).all(dim=1))
    return pts, lp, tid, inside


def _skeleton_chunks(entry_data, entry_vals, seg_starts, seg_lens, pts,
                     tid, inside, point_chunk):
    """The inside points whose tile has candidates, `point_chunk` at a
    time: per chunk (point ids, each point's candidate entries in
    ascending stream order with the kept ones first, the kept mask: the
    strict positive-weight filter at the point)."""
    num_entries = entry_data.shape[0]
    tabs = _segment_tables(seg_starts, seg_lens)
    totals = tabs[3]
    occ = torch.nonzero(inside & (totals[tid] > 0)).squeeze(1)
    occ_tot = totals[tid[occ]].cpu()
    cut = float(np.float32(RADIUS_CUTOFF))
    big = torch.iinfo(torch.int64).max

    for s in range(0, len(occ), point_chunk):
        pidx = occ[s:s + point_chunk]
        width = int(occ_tot[s:s + point_chunk].max())
        idx, ok = _slot_entries(tabs, tid[pidx], width, num_entries)
        data = entry_data[idx]                                  # (C, K, 8)
        pg = pts[pidx].to(torch.float32)
        dx = data[..., 0:3] - pg[:, None, :]
        valid = ok & (dot3(dx, dx) * data[..., 3] < cut)
        # Canonical order: ascending stream order (a splat sits at most
        # once in one tile's chain).
        key = torch.where(valid, entry_vals[idx], torch.full_like(idx, big))
        order = torch.sort(key, dim=1, stable=True).indices
        yield pidx, torch.gather(idx, 1, order), torch.gather(valid, 1, order)


def skeleton_moments(entry_data: torch.Tensor, entry_vals: torch.Tensor,
                     seg_starts: torch.Tensor, seg_lens: torch.Tensor,
                     pts: torch.Tensor, tid: torch.Tensor,
                     inside: torch.Tensor, point_chunk: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The moments step of the skeleton pass (plain version of the skeleton
    kernel, csrc/seam_moments.cu): (P, 1, 9) f32 moments and (P, 1) int32
    hit counts at each point inside the block (zero elsewhere and where
    its tile is empty): candidates from the one tile `tid` whose closed
    box holds the point (_skeleton_chunks), arithmetic in the frame of the
    global 8-aligned cube holding the point."""
    dev = entry_data.device
    moments = torch.zeros((pts.shape[0], 1, 9), dtype=torch.float32,
                          device=dev)
    hits = torch.zeros((pts.shape[0], 1), dtype=torch.int32, device=dev)
    for pidx, idx, valid in _skeleton_chunks(entry_data, entry_vals,
                                             seg_starts, seg_lens, pts, tid,
                                             inside, point_chunk):
        kept = int(valid.sum(dim=1).max())
        cols_idx, sval = _take_slots(idx, valid, _pow2(kept))
        base, corner = _point_frames(pts[pidx])
        moments[pidx], hits[pidx] = _canonical_sums(
            entry_data, cols_idx, sval, base, corner)
    return moments, hits


def skeleton_work(entry_data: torch.Tensor, entry_vals: torch.Tensor,
                  seg_starts: torch.Tensor, seg_lens: torch.Tensor,
                  pts: torch.Tensor, tid: torch.Tensor,
                  inside: torch.Tensor) -> Tuple[int, int]:
    """The skeleton pass's work measure, as face_work: (candidate slots
    listed, over the inside points' tiles; candidates kept; corners
    written, one an inside point; of those, the corners with HITS_CUTOFF
    hits or more)."""
    totals = seg_lens.to(torch.int64).sum(dim=1)
    listed = int((totals[tid] * inside).sum())
    kept = sum(int(v.sum()) for _, _, v in _skeleton_chunks(
        entry_data, entry_vals, seg_starts, seg_lens, pts, tid, inside, 64))
    _, hits = skeleton_moments(entry_data, entry_vals, seg_starts, seg_lens,
                               pts, tid, inside)
    fitted = int(((hits[:, 0] >= HITS_CUTOFF) & inside).sum())
    return listed, kept, int(inside.sum()), fitted


def _point_frames(pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each point's frame, the global 8-aligned cube holding it ((P, 3)
    f32), and the point in that frame ((P, 1, 3) f32)."""
    base = torch.div(pts, TILE, rounding_mode="floor") * TILE
    return (base.to(torch.float32),
            (pts - base).to(torch.float32)[:, None, :])


def fit_points(field: torch.Tensor, m: torch.Tensor, hits: torch.Tensor,
               pts: torch.Tensor, lp: torch.Tensor, inside: torch.Tensor,
               fit_shape: str, boundary_factor: float) -> torch.Tensor:
    """The fit at every skeleton point from its moments, written into
    `field` at the points inside the block: the plain skeleton pass's last
    step (the skeleton kernel writes each inside point's own corner). A
    point whose tile is empty fits to NaN (no hits). No host sync: a point
    outside the block rewrites the first inside point's location with the
    value that location gets (or, with none inside, corner 0 with its own
    value), so the scatter needs no mask."""
    _, corner = _point_frames(pts)
    vals = _fit(m, corner, hits, fit_shape, boundary_factor)[:, 0]
    b = field.shape[0]
    flat = field.view(-1)
    lin = (lp[:, 2] * b + lp[:, 1]) * b + lp[:, 0]
    first = torch.argmax(inside.to(torch.uint8)).view(1)
    any_in = inside.index_select(0, first)
    tgt = torch.where(inside, lin, torch.where(
        any_in, lin.index_select(0, first), torch.zeros_like(first)))
    v0 = torch.where(any_in, vals.index_select(0, first), flat[0:1])
    flat.index_put_((tgt,), torch.where(inside, vals, v0))
    return field


def skeleton_point_field(field: torch.Tensor, entry_data: torch.Tensor,
                         entry_vals: torch.Tensor, seg_starts: torch.Tensor,
                         seg_lens: torch.Tensor, cell_origin: Sequence[int],
                         points: torch.Tensor, tiles_per_axis: int,
                         fit_shape: str, boundary_factor: float,
                         point_chunk: int = 64) -> torch.Tensor:
    """Recompute `field` (in place) at decomposition edge-skeleton points so
    every block containing such a point computes a bitwise-identical value
    (plain version): skeleton_points, skeleton_moments, fit_points.
    points: (P, 3) int global corner coords (x, y, z); rows with a
    negative coordinate or outside the block are ignored. A point whose
    tile holds no candidates becomes NaN. Returns `field`."""
    if points is None or points.shape[0] == 0:
        return field
    pts, lp, tid, inside = skeleton_points(
        points.to(field.device), cell_origin, tiles_per_axis, field.shape[0])
    m, hits = skeleton_moments(entry_data, entry_vals, seg_starts, seg_lens,
                               pts, tid, inside, point_chunk)
    return fit_points(field, m, hits, pts, lp, inside, fit_shape,
                      boundary_factor)
