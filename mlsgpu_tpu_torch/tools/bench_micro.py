"""Micro-benchmarks of block-step sub-stages on the bench block, the densest
bucket of the bench cloud (port of mlsgpu_tpu/tools/bench_micro.py):

- binning split three ways: the key pass alone, keys and sort without the
  gather, and the whole of `bin_splats` (the plain versions); on a card
  also the kernel path (ops/binning_cuda.py) split the same way, and the
  tile segments through their kernel and their plain version;
- the canonical face pass: on a card its kernel path (ops/seam_cuda.py,
  one launch for the block), then its plain version by rows per chunk
  (`ops/mls.py` runs 32 rows at a time, with host synchronisations per
  chunk for the width of its candidate lists); and at ROW_TREE_CHUNKS rows
  the plain pass as it summed before its per-corner sort (one pairwise
  tree over each row's whole candidate list, `row_tree_sums`: a plain
  reference for timing only, since its sums depend on the block); then
  the skeleton pass at the block's skeleton points, the kernel path on a
  card and the plain version;
- classification's parts: the candidate-tile reduction and 9^3 gather of
  the tiled form, the tiled form whole, the dense form's signs and codes
  alone, the dense form whole, and codes-mode marching whole (the plain
  version); on a card also the codes image through its kernels
  (ops/marching_cuda.py: classify, scan, the totals' copy, emit).

Left out: the JAX tool's probe of `_classify_tiled` under a tile cap (the
port sizes its candidate tiles from their true count and has no cap).

Prints one JSON line per variant, `{"name", "median_ms", "min_ms", ...}`,
on the host's clock (time.perf_counter around the call and a device
synchronisation), after a warm-up call.

Usage:
    python -m mlsgpu_tpu_torch.tools.bench_micro [--splats 2000000]
        [--levels 6] [--reps 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

FACE_CHUNKS = (16, 32, 64, 128, 256)
ROW_TREE_CHUNKS = (32, 256)


def add_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--splats", type=int, default=2_000_000)
    p.add_argument("--levels", type=int, default=6)
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda, cuda:<i> or cpu [%(default)s]")


class BenchBlock:
    """The bench block on a device: the densest bucket of the bench cloud
    of `splats` splats as the loader hands it to the block step, and the
    configuration's shifts."""

    def __init__(self, splats: int, levels: int, device: str):
        import torch

        from mlsgpu_tpu_torch.device import resolve_device
        from mlsgpu_tpu_torch.io.splat_set import SequenceSource
        from mlsgpu_tpu_torch.pipeline.streamer import load_bucket
        from mlsgpu_tpu_torch.tools import cloud

        self.dev = resolve_device(device)
        cloud_splats, sr = cloud.make_cloud(splats)
        self.cfg = cfg = cloud.bench_config(sr, levels=levels)
        src = SequenceSource(cloud_splats)
        info, _, b = cloud.densest_bucket(src, cfg)
        grid_form, valid = load_bucket(src, info, b)
        self.region = tuple(int(v) for v in b.cell_hi - b.cell_lo)
        self.points = torch.as_tensor(b.skeleton, device=self.dev)
        self.origin = tuple(int(v) for v in b.cell_lo)
        self.min_shift = cfg.subsampling
        self.max_shift = cfg.device_shift
        self.tpa = 1 << (self.max_shift - 3)
        self.bf = float(cfg.boundary_factor)
        self.splats = torch.as_tensor(grid_form, device=self.dev)
        self.valid = torch.as_tensor(valid, device=self.dev)
        print(f"# device={self.dev} block: {len(grid_form)} splats, region "
              f"{self.region}, origin {self.origin}", file=sys.stderr,
              flush=True)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            import torch
            torch.cuda.synchronize(self.dev)

    def timeit(self, name: str, fn, reps: int, **extra) -> float:
        """Median host milliseconds of fn() ended by a synchronisation,
        after one warm-up call; printed as one JSON line."""
        fn()
        self.sync()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            self.sync()
            ts.append(time.perf_counter() - t0)
        med = float(np.median(ts)) * 1e3
        print(json.dumps({"name": name, "median_ms": med,
                          "min_ms": min(ts) * 1e3, "reps": reps, **extra}),
              flush=True)
        return med

    def binned_field(self):
        """(binned entries, segment starts, lens, the MLS field before the
        face and skeleton passes) of the block."""
        from mlsgpu_tpu_torch.ops import binning_cuda, mls_cuda
        binned = binning_cuda.bin_splats(self.splats, self.valid,
                                         self.origin, self.min_shift,
                                         self.max_shift)
        starts, lens = binning_cuda.tile_segments(
            binned.entry_keys, self.min_shift, self.max_shift, self.tpa)
        field, _, _ = mls_cuda.eval_field(
            binned.entry_data, starts, lens, self.origin, self.tpa,
            self.cfg.fit_shape, self.bf)
        return binned, starts, lens, field


def row_tree_sums(entry_data, cols_idx, sval, frame, corners):
    """ops/mls.py's `_canonical_sums` without its per-corner sort: each
    corner sums its row's whole candidate list, zero weights included, as
    the JAX package's face pass does, so its sums depend on the block. For
    timing only."""
    import torch

    from mlsgpu_tpu_torch.ops import mls
    cols = entry_data[cols_idx]
    x = cols[..., 0:3] - frame[:, None, :]
    feats = mls._features(x, cols[..., 4:7])
    w, hits = mls._weights(corners, x, feats, cols[..., 3], cols[..., 7],
                           sval)
    return (mls._tree_sum(w[..., None] * feats[:, None, :, :], dim=2),
            hits.to(torch.int32))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_arguments(p)
    args = p.parse_args(argv)

    import torch

    from mlsgpu_tpu_torch.ops import (binning, binning_cuda, marching,
                                      marching_cuda, mls, seam_cuda)

    blk = BenchBlock(args.splats, args.levels, args.device)
    sp, va, org = blk.splats, blk.valid, blk.origin
    lo, hi = blk.min_shift, blk.max_shift

    # ---- binning internals ------------------------------------------------
    def keys(path=binning):
        return path.splat_keys(sp, va, org, lo, hi)

    blk.timeit("bin keys only (no sort)", keys, args.reps)
    blk.timeit("bin keys+sort (no gather)",
               lambda: torch.sort(keys(), stable=True), args.reps)
    blk.timeit("bin full (sort+gather)",
               lambda: binning.bin_splats(sp, va, org, lo, hi), args.reps)
    if blk.dev.type == "cuda":
        blk.timeit("bin keys kernel", lambda: keys(binning_cuda), args.reps)
        blk.timeit("bin keys kernel+sort",
                   lambda: torch.sort(keys(binning_cuda), stable=True),
                   args.reps)
        blk.timeit("bin full kernels (keys, sort, entries)",
                   lambda: binning_cuda.bin_splats(sp, va, org, lo, hi),
                   args.reps)
        entry_keys = binning_cuda.bin_splats(sp, va, org, lo, hi).entry_keys
        for name, path in (("kernel", binning_cuda), ("plain", binning)):
            blk.timeit(f"segments {name}",
                       lambda p=path: p.tile_segments(entry_keys, lo, hi,
                                                      blk.tpa),
                       args.reps)
        del entry_keys

    # ---- face pass by rows per chunk --------------------------------------
    binned, starts, lens, field = blk.binned_field()
    totals = lens.sum(dim=1)
    print(json.dumps({"name": "tiles", "nonzero": int((totals > 0).sum()),
                      "total": int(totals.shape[0])}), flush=True)
    face_args = (binned.entry_data, binned.entry_vals, starts, lens, org,
                 blk.region, blk.tpa, blk.cfg.fit_shape, blk.bf)
    skeleton_args = (binned.entry_data, binned.entry_vals, starts, lens, org,
                     blk.points, blk.tpa, blk.cfg.fit_shape, blk.bf)
    if blk.dev.type == "cuda":
        blk.timeit("faces kernel",
                   lambda: seam_cuda.canonical_face_field(field.clone(),
                                                          *face_args),
                   args.reps)
    for chunk in FACE_CHUNKS:
        blk.timeit(
            f"faces chunk={chunk}",
            lambda c=chunk: mls.canonical_face_field(
                field.clone(), binned.entry_data, binned.entry_vals, starts,
                lens, org, blk.region, blk.tpa, blk.cfg.fit_shape, blk.bf,
                row_chunk=c),
            args.reps, row_chunk=chunk)
    per_corner = mls._canonical_sums
    try:
        mls._canonical_sums = row_tree_sums
        for chunk in ROW_TREE_CHUNKS:
            blk.timeit(
                f"faces per-row tree chunk={chunk}",
                lambda c=chunk: mls.canonical_face_field(
                    field.clone(), binned.entry_data, binned.entry_vals,
                    starts, lens, org, blk.region, blk.tpa,
                    blk.cfg.fit_shape, blk.bf, row_chunk=c),
                args.reps, row_chunk=chunk)
    finally:
        mls._canonical_sums = per_corner
    if blk.dev.type == "cuda":
        blk.timeit("skeleton kernel",
                   lambda: seam_cuda.skeleton_point_field(field.clone(),
                                                          *skeleton_args),
                   args.reps, points=int(blk.points.shape[0]))
    blk.timeit("skeleton plain",
               lambda: mls.skeleton_point_field(field.clone(),
                                                *skeleton_args),
               args.reps, points=int(blk.points.shape[0]))

    # ---- classification internals -----------------------------------------
    tile = marching.TILE

    def classify_candidates_only():
        """The tiled form's dense candidate reduction and its 9^3 gather."""
        b = field.shape[0]
        g = -(-(b - 1) // tile)
        pad = g * tile + 1 - b
        fpad = torch.nn.functional.pad(field, (0, pad, 0, pad, 0, pad),
                                       value=float("nan"))
        gt = g * tile
        cand = (torch.isfinite(fpad[:gt, :gt, :gt])
                .reshape(g, tile, g, tile, g, tile).permute(0, 2, 4, 1, 3, 5)
                .reshape(g ** 3, tile ** 3).any(dim=1))
        tids = torch.nonzero(cand).squeeze(1)
        r9 = torch.arange(tile + 1, device=field.device)
        zi = (tids // (g * g))[:, None] * tile + r9
        yi = ((tids // g) % g)[:, None] * tile + r9
        xi = (tids % g)[:, None] * tile + r9
        return fpad[zi[:, :, None, None], yi[:, None, :, None],
                    xi[:, None, None, :]]

    def classify_dense_signs_only():
        """The dense form's signs, codes and finite mask, no compaction."""
        nc = field.shape[0] - 1
        code = torch.zeros((nc, nc, nc), dtype=torch.int64,
                           device=field.device)
        finite = torch.ones((nc, nc, nc), dtype=torch.bool,
                            device=field.device)
        for v, (dx, dy, dz) in enumerate(marching.CORNER_OFFS):
            cv = field[dz:dz + nc, dy:dy + nc, dx:dx + nc]
            code |= (cv >= 0.0).to(torch.int64) << v
            finite &= torch.isfinite(cv)
        return finite & (code != 0) & (code != 255)

    blk.timeit("classify cand+gather only", classify_candidates_only,
               args.reps)
    blk.timeit("classify tiled full",
               lambda: marching.classify_tiled(field, blk.region), args.reps)
    blk.timeit("classify dense signs only", classify_dense_signs_only,
               args.reps)
    blk.timeit("classify dense full",
               lambda: marching.classify_dense(field, blk.region), args.reps)
    blk.timeit("march codes full",
               lambda: marching.generate_codes(field, blk.region), args.reps)
    if blk.dev.type == "cuda":
        blk.timeit("march codes image (kernels)",
                   lambda: marching_cuda.codes_image(field, blk.region),
                   args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
