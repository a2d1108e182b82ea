"""Second set of micro-benchmarks on the bench block (port of
mlsgpu_tpu/tools/bench_micro2.py):

- the binning key pass with parts switched off in turn (no Morton
  interleave, no sphere/slab test, one fixed level), to see which part of
  the pass costs what;
- the face pass: how many of its patch rows are occupied and how many
  distinct tiles a row draws from, then on a card its kernel path (one
  launch, ops/seam_cuda.py) and its plain version at 32 and 256 rows per
  chunk;
- the MLS field call by candidates per tile: the block's splats thinned to
  every k-th, so the same tiles hold fewer candidates each (the field
  kernel on a card, the plain version on the CPU).

Left out: the JAX tool's sweep of the Pallas kernel's CHUNK window (the
port's kernel has no such parameter; the thinning sweep above takes its
place) and its per-axis rewrite of the key pass, which is already the form
`ops/binning.py` has.

Prints one JSON line per variant, on the host's clock as tools/bench_micro
does.

Usage:
    python -m mlsgpu_tpu_torch.tools.bench_micro2 [--splats 2000000]
        [--levels 6] [--reps 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

KEY_VARIANTS = (("keys full", {}),
                ("keys no morton", {"do_morton": False}),
                ("keys no slab test", {"do_slab": False}),
                ("keys fixed shift", {"var_shift": False}))
THINNING = (1, 2, 4, 8)


def keys_variant(splats, valid, origin, min_shift, max_shift, *,
                 do_morton=True, do_slab=True, var_shift=True):
    """`ops.binning.splat_keys` with parts switched off (the keys are then
    wrong; only the time is of interest)."""
    import torch

    from mlsgpu_tpu_torch.ops import binning, morton

    dev = splats.device
    r = splats[:, 3]
    px = [splats[:, a] for a in range(3)]
    org = [int(origin[a]) for a in range(3)]
    lo_g = [torch.floor(px[a] - r).to(torch.int64) for a in range(3)]
    hi_g = [torch.floor(px[a] + r).to(torch.int64) for a in range(3)]
    big = torch.maximum(torch.maximum(hi_g[0] - lo_g[0], hi_g[1] - lo_g[1]),
                        hi_g[2] - lo_g[2])
    if var_shift:
        shift = torch.clamp(binning.level_shift(big), min_shift, max_shift)
    else:
        shift = torch.full_like(big, min(min_shift + 1, max_shift))
    ilo = [torch.clamp(lo_g[a] - org[a], min=0) >> shift for a in range(3)]
    offs = torch.as_tensor(binning.level_offsets(min_shift, max_shift),
                           device=dev)
    level_offset = offs[shift - min_shift]
    bound = torch.ones_like(shift) << (max_shift - shift)
    r2c = r * r * float(np.float32(1.00001))

    def axis_d2(a, d):
        addr = ilo[a] + d
        blo = ((addr << shift) + org[a]).to(torch.float32)
        bhi = (((addr + 1) << shift) + org[a]).to(torch.float32)
        dd = torch.clamp(px[a], min=blo, max=bhi) - px[a]
        return addr, dd * dd

    tabs = [[axis_d2(a, d) for d in (0, 1)] for a in range(3)]
    invalid = torch.full_like(big, binning.INVALID_KEY)
    out = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                (ax, d2x), (ay, d2y), (az, d2z) = (
                    tabs[0][dx], tabs[1][dy], tabs[2][dz])
                ok = valid & (ax < bound) & (ay < bound) & (az < bound)
                if do_slab:
                    ok = ok & ((d2x + d2y + d2z) < r2c)
                if do_morton:
                    key = level_offset + morton.encode(ax, ay, az)
                else:
                    key = level_offset + ax + ay * 7 + az * 13
                out.append(torch.where(ok, key, invalid))
    return torch.cat(out)


def face_row_occupancy(lens, origin, region, tpa) -> dict:
    """The patch rows of `ops.mls.canonical_face_field` for this block
    (ops.mls.face_rows): how many there are, how many have candidates in
    any of their four covering tiles, and the mean number of distinct
    covering tiles per row."""
    from mlsgpu_tpu_torch.ops import mls
    totals = lens.sum(dim=1).cpu().numpy()
    tid4 = mls.face_rows(origin, region, tpa)[:, mls.ROW_TILES:]
    occupied = totals[tid4].max(axis=1) > 0
    return {"face_rows": int(len(tid4)),
            "occupied_rows": int(occupied.sum()),
            "distinct_tiles_per_row": float(np.mean(
                [len(set(r)) for r in tid4]))}


def main(argv=None) -> int:
    from mlsgpu_tpu_torch.tools.bench_micro import BenchBlock, add_arguments

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_arguments(p)
    args = p.parse_args(argv)

    from mlsgpu_tpu_torch.ops import binning, mls, mls_cuda, seam_cuda

    blk = BenchBlock(args.splats, args.levels, args.device)
    sp, va, org = blk.splats, blk.valid, blk.origin
    lo, hi = blk.min_shift, blk.max_shift

    # ---- the key pass with parts switched off -----------------------------
    for name, kw in KEY_VARIANTS:
        blk.timeit(f"bin {name}",
                   lambda kw=kw: keys_variant(sp, va, org, lo, hi, **kw),
                   args.reps)

    # ---- the face pass: row occupancy, then two chunk sizes ---------------
    binned, starts, lens, field = blk.binned_field()
    occupancy = face_row_occupancy(lens, org, blk.region, blk.tpa)
    print(json.dumps({"name": "face rows", **occupancy}), flush=True)
    if blk.dev.type == "cuda":
        blk.timeit(
            "faces kernel",
            lambda: seam_cuda.canonical_face_field(
                field.clone(), binned.entry_data, binned.entry_vals, starts,
                lens, org, blk.region, blk.tpa, blk.cfg.fit_shape, blk.bf),
            args.reps)
    for chunk in (32, 256):
        blk.timeit(
            f"faces chunk={chunk}",
            lambda c=chunk: mls.canonical_face_field(
                field.clone(), binned.entry_data, binned.entry_vals, starts,
                lens, org, blk.region, blk.tpa, blk.cfg.fit_shape, blk.bf,
                row_chunk=c),
            args.reps, row_chunk=chunk,
            chunks=-(-occupancy["occupied_rows"] // chunk))
    del binned, starts, lens, field

    # ---- the MLS call by candidates per tile ------------------------------
    for k in THINNING:
        b = binning.bin_splats(sp[::k].contiguous(), va[::k].contiguous(),
                               org, lo, hi)
        st, ln = binning.tile_segments(b.entry_keys, lo, hi, blk.tpa)
        per_tile = ln.sum(dim=1)
        occ = int((per_tile > 0).sum())
        blk.timeit(
            f"mls 1/{k} of the splats",
            lambda b=b, st=st, ln=ln: mls_cuda.eval_field(
                b.entry_data, st, ln, org, blk.tpa, blk.cfg.fit_shape,
                blk.bf),
            args.reps, occupied_tiles=occ,
            candidates_per_occupied_tile=(float(per_tile.sum()) / occ
                                          if occ else 0.0),
            max_candidates_per_tile=int(per_tile.max()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
