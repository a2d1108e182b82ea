"""Near-twin crack sites of a `tools/bench_ooc` run's chunk files, and
every block's field around each: tells a seam defect (the blocks that hold
a corner disagree on its value) from vertices that f32 rounding puts onto
a cut plane (the blocks agree, and the vertices sit within rounding of a
corner).

The run is repeated up to its buckets (the blob pass and bucketing are
deterministic); for each of the first --sites crack corners, every bucket
whose closed box holds the corner runs `ops.block.block_field` (face and
skeleton passes included) and its values at the 27 corners around it are
compared bit for bit.

Usage:
    python -m mlsgpu_tpu_torch.tools.twin_sites --out OUT_BASE.ply \\
        --splats N [bench_ooc's options, as for the run] [--sites 10]

Prints one JSON line per crack vertex ("crack": its grid coordinates, the
distance from them to the nearest corner, its twin's), one per examined
site ("site": the corner, the buckets holding it, the corners where the
blocks disagree), then a summary line.
"""

from __future__ import annotations

import json
import sys

import numpy as np


def crack_vertices(base: str):
    """([(chunk pair, axis, side, vertex, twin)] for every near-twin crack
    vertex of the chunk files of `base`, as tools/verify_chunks counts
    them; the files' geometry comment)."""
    from mlsgpu_tpu_torch.tools import verify_chunks
    chunks = verify_chunks.discover_chunks(base)
    geom = verify_chunks.parse_geom_comment(next(iter(chunks.values())))
    out = []
    verify_chunks.check_continuity(
        chunks, geom, on_crack=lambda *crack: out.append(crack))
    return out, geom


def grid_coords(world, geom) -> np.ndarray:
    """Grid-local float64 coordinates of world-frame vertices (the
    mesher's transform, world = (grid + ext_lo) * spacing + reference,
    undone in float64)."""
    return ((np.asarray(world, np.float64) - geom["reference"])
            / geom["spacing"] - geom["ext_lo"])


def scan_buckets(args):
    """(procedural scan, blob info, buckets, configuration) of a
    bench_ooc run with these parsed options, bucketed as reconstruct()
    buckets it."""
    from mlsgpu_tpu_torch.pipeline import blobs as blobs_mod
    from mlsgpu_tpu_torch.pipeline import bucket as bucket_mod
    from mlsgpu_tpu_torch.pipeline.reconstruct import output_chunk_cells
    from mlsgpu_tpu_torch.tools import bench_ooc
    src, cfg = bench_ooc.scan_config(args)
    info = blobs_mod.compute_blobs(src, cfg.fit_grid, cfg.micro_cells)
    buckets = bucket_mod.make_buckets(
        info, cfg.device_block_cells, cfg.micro_cells,
        max_splats=min(cfg.max_device_splats, cfg.mem_bucket_splats // 32),
        chunk_cells=output_chunk_cells(cfg), max_split=cfg.max_split)
    return src, info, buckets, cfg


def blocks_around(source, info, buckets, cfg, corner, device) -> dict:
    """{bucket index: ((3, 3, 3) float32 field values [z, y, x] around
    `corner`, (3, 3, 3) bool: the block holds that corner)} for every
    bucket whose closed box holds `corner` (global grid-local corner
    coordinates, x y z)."""
    import torch

    from mlsgpu_tpu_torch.ops import block
    from mlsgpu_tpu_torch.pipeline.streamer import load_bucket
    corner = np.asarray(corner, np.int64)
    offs = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"),
                    axis=-1)[..., ::-1]                  # [z, y, x] -> (x, y, z)
    out = {}
    for i, b in enumerate(buckets):
        if (corner < b.cell_lo).any() or (corner > b.cell_hi).any():
            continue
        splats, valid = load_bucket(source, info, b)
        pts = (None if b.skeleton is None or not len(b.skeleton)
               else torch.as_tensor(b.skeleton, device=device))
        field, _ = block.block_field(
            torch.as_tensor(splats, device=device),
            torch.as_tensor(valid, device=device),
            tuple(int(v) for v in b.cell_hi - b.cell_lo),
            tuple(int(v) for v in b.cell_lo), float(cfg.boundary_factor),
            pts, levels=cfg.device_levels, subsampling=cfg.subsampling,
            fit_shape=cfg.fit_shape)
        local = corner + offs - b.cell_lo
        held = ((local >= 0) & (local <= b.cell_hi - b.cell_lo)).all(-1)
        loc = np.where(held[..., None], local, 0)
        vals = field.cpu().numpy()[loc[..., 2], loc[..., 1], loc[..., 0]]
        out[i] = (vals, held)
    return out


def disagreeing(values: dict) -> list:
    """The [dz, dy, dx] offsets (0..2) at which the blocks that hold that
    corner do not all have the same bits."""
    bad = []
    for off in np.ndindex(3, 3, 3):
        bits = {int(vals[off].view(np.uint32)) for vals, held in
                values.values() if held[off]}
        if len(bits) > 1:
            bad.append(list(off))
    return bad


def main(argv=None) -> int:
    from mlsgpu_tpu_torch.tools import bench_ooc
    p = bench_ooc.parser(__doc__.splitlines()[0])
    p.add_argument("--sites", type=int, default=10,
                   help="crack corners whose blocks to compare [10]")
    args = p.parse_args(argv)

    from mlsgpu_tpu_torch.device import resolve_device

    cracks, geom = crack_vertices(args.out)
    corners, dist = [], 0.0
    for pair, axis, side, v, twin in cracks:
        g = grid_coords(v, geom)
        c = np.round(g).astype(np.int64)
        dist = max(dist, float(np.abs(g - c).max()))
        print(json.dumps({"crack": {
            "pair": [list(pair[0]), list(pair[1])], "axis": axis,
            "only_in": side, "grid": g.tolist(),
            "corner_distance": float(np.abs(g - c).max()),
            "twin_grid": grid_coords(twin, geom).tolist()}}), flush=True)
        if tuple(c) not in corners:
            corners.append(tuple(c))
    agree = 0
    sites = corners[:args.sites]
    if sites:
        dev = resolve_device(args.device)
        src, info, buckets, cfg = scan_buckets(args)
        for c in sites:
            values = blocks_around(src, info, buckets, cfg, c, dev)
            bad = disagreeing(values)
            agree += not bad
            print(json.dumps({"site": {
                "corner": list(map(int, c)), "buckets": [
                    {"index": i, "cell_lo": buckets[i].cell_lo.tolist(),
                     "cell_hi": buckets[i].cell_hi.tolist()}
                    for i in values],
                "disagree_at": bad}}), flush=True)
    print(json.dumps({"cracks": len(cracks), "corners": len(corners),
                      "max_corner_distance": dist,
                      "sites": len(sites), "sites_blocks_agree": agree}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
