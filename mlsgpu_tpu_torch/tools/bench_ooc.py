"""Out-of-core scale benchmark (BASELINE.md configs 3/4; port of
mlsgpu_tpu/tools/bench_ooc.py, same options plus --device): reconstruct a
procedurally-generated ~100M+ splat scan with enforced host memory budgets
and report throughput plus peak RSS.

The input is a `ProceduralScanSource`: a Morton-ordered (spatially coherent,
like real scanner sweeps — the property FastBlobSet depends on,
src/splat_set.h:653-708) sphere scan generated deterministically per chunk,
so no multi-GB input file has to exist; `read_ranges` regenerates any id
range on demand. IO accounting still exercises the real pipeline paths:
blob store (RAM or disk past --mem-blobs), byte-budgeted loader queue,
spill-based mesher, streamed two-pass write.

Usage:
    python -m mlsgpu_tpu_torch.tools.bench_ooc --splats 100000000 \
        --mem-blobs 256M --out OUTDIR/ooc.ply

Without --out the mesh goes to out.ply in a fresh directory under the
system's temporary directory (tempfile.mkdtemp, so TMPDIR is honoured and
two runs never share files); its path is in the result's "out" key.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np

from mlsgpu_tpu_torch.io.splat_set import SplatSource


class ProceduralScanSource(SplatSource):
    """Deterministic synthetic scan of a sphere, Morton-ordered for spatial
    coherence. Any [a, b) id range is regenerated on demand — the disk-free
    stand-in for a multi-hundred-GB input set."""

    def __init__(self, n: int, radius: float = 3.0, seed: int = 123,
                 splat_scale: float = 1.0):
        self._n = int(n)
        self._radius = float(radius)
        self._seed = seed
        # splat radius ~3x mean sample spacing for solid coverage;
        # splat_scale widens it for coarse-grid runs (--grid-scale) so the
        # MLS support still reaches every corner of a surface-crossing
        # cell — at reach < ~1.7 cells (the cell diagonal) corners beyond
        # the splats' support go NaN and the surface turns to swiss
        # cheese (seen with the JAX package: a grid-scale 2.5 run with
        # unscaled radii had HALF its cut-plane vertices on open
        # boundaries).
        self._sr = 3.0 * np.sqrt(4 * np.pi * radius ** 2 / n) * splat_scale
        # Coherence ordering: sample directions in a coarse lat-long sweep
        # with deterministic jitter — consecutive ids are spatial neighbors
        # (scanline order), like a real scanner pass.
        self._bands = max(int(np.sqrt(self._n / 2)), 1)

    @property
    def splat_radius(self) -> float:
        return self._sr

    def __len__(self) -> int:
        return self._n

    def _gen(self, a: int, b: int) -> np.ndarray:
        return self._gen_ids(np.arange(a, b, dtype=np.int64))

    def _gen_ids(self, ids: np.ndarray) -> np.ndarray:
        # Chunk the vectorized generation: the f64 temporaries of a multi-M
        # id batch blow the cache hierarchy, so bound the working set and
        # write into one preallocated output.
        step = 512 * 1024
        if len(ids) <= step:
            return self._gen_ids_block(ids)
        out = np.empty((len(ids), 8), dtype=np.float32)
        for s in range(0, len(ids), step):
            out[s:s + step] = self._gen_ids_block(ids[s:s + step])
        return out

    def _gen_ids_block(self, ids: np.ndarray) -> np.ndarray:
        # lat-long sweep: band = latitude row, position in band = longitude
        band = ids * self._bands // self._n
        in_band = ids - band * self._n // self._bands
        band_len = np.maximum((band + 1) * self._n // self._bands
                              - band * self._n // self._bands, 1)
        # deterministic per-id jitter from a counter-based hash
        u = ids.astype(np.uint64)
        h = (u * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33)
        j1 = (h & np.uint64(0x7FFFFFFF)).astype(np.float64) / 2**31 - 0.5
        h2 = (u * np.uint64(0xC2B2AE3D27D4EB4F)) >> np.uint64(33)
        j2 = (h2 & np.uint64(0x7FFFFFFF)).astype(np.float64) / 2**31 - 0.5
        # Equal-AREA bands (uniform in cos theta): uniform surface density
        # with scanline coherence. Uniform-in-theta banding oversamples the
        # poles ~1/sin(theta), which blows the per-tile candidate cap (same
        # fix as bench.py's cloud).
        ct = np.clip(1.0 - 2.0 * (band + 0.5 + 0.9 * j1) / self._bands,
                     -1.0, 1.0)
        phi = (in_band + 0.5 + 0.9 * j2) / band_len * 2 * np.pi
        st = np.sqrt(1.0 - ct * ct)  # sin(arccos(ct)), minus the trig
        v = np.stack([st * np.cos(phi), st * np.sin(phi), ct], axis=1)
        out = np.zeros((len(ids), 8), dtype=np.float32)
        out[:, 0:3] = (self._radius * v).astype(np.float32)
        out[:, 3] = self._sr
        out[:, 4:7] = v.astype(np.float32)
        out[:, 7] = 1.0
        return out

    def iter_chunks(self, chunk_size: int = 4 * 1024 * 1024):
        for start in range(0, self._n, chunk_size):
            stop = min(start + chunk_size, self._n)
            yield start, self._gen(start, stop)

    def read_ranges(self, ranges):
        # One vectorized generation over all ranges: per-call numpy overhead
        # dominates when a bucket reads thousands of short blob runs.
        ranges = list(ranges)
        if not ranges:
            return np.empty((0, 8), np.float32)
        ids = np.concatenate(
            [np.arange(a, b, dtype=np.int64) for a, b in ranges])
        return self._gen_ids(ids)


def peak_rss_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--splats", type=int, default=100_000_000)
    p.add_argument("--out", default=None,
                   help="output PLY (chunk files and the mesher's spill go "
                        "beside it) [out.ply in a new temporary directory]")
    p.add_argument("--levels", type=int, default=6)
    p.add_argument("--device-shift", type=int, default=None,
                   help="--device-block-shift: log2 corners per device "
                        "dispatch (blocks above it stream as sub-volumes)")
    p.add_argument("--grid-scale", type=float, default=1.0,
                   help="grid spacing multiplier (>1 = coarser mesh; config-4"
                        " 1B runs need ~2-3x to fit output+spill on disk)")
    p.add_argument("--splat-scale", type=float, default=None,
                   help="splat radius multiplier; default 0.8*grid-scale "
                        "keeps the MLS support ~2.4 cells of reach on "
                        "coarse grids (closed surfaces) at ~4x the per-"
                        "tile candidate load of the unit ratio")
    p.add_argument("--checkpoint", default=None,
                   help="run all compute passes, then serialize mesher state"
                        " to PATH instead of writing (config-4 protocol:"
                        " checkpoint midway, then --resume finishes)")
    p.add_argument("--resume", default=None,
                   help="skip compute; load mesher state from PATH and"
                        " perform only the final write")
    p.add_argument("--mem-blobs", default="256M")
    p.add_argument("--mem-load-splats", default="256M")
    p.add_argument("--mem-host-splats", default="512M")
    p.add_argument("--mem-mesh", default="512M")
    p.add_argument("--mem-reorder", default="2G")
    p.add_argument("--rss-budget", default="16G",
                   help="fail if peak RSS exceeds this")
    p.add_argument("--split-size", default="500M",
                   help="output chunking (keeps single-file writes bounded)")
    p.add_argument("--verify", type=int, default=10, metavar="N",
                   help="after the run: manifold-check N sampled chunks and "
                        "run the cross-chunk continuity pass "
                        "(tools/verify_chunks); 0 = skip")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda or cpu [%(default)s]")
    args = p.parse_args(argv)

    from mlsgpu_tpu_torch.config import ReconstructConfig, parse_capacity
    from mlsgpu_tpu_torch.pipeline.reconstruct import reconstruct
    from mlsgpu_tpu_torch.utils.statistics import get_registry

    splat_scale = (args.splat_scale if args.splat_scale is not None
                   else max(1.0, 0.8 * args.grid_scale))
    src = ProceduralScanSource(args.splats, splat_scale=splat_scale)
    # spacing derives from the UNSCALED sample spacing so --grid-scale
    # alone sets the grid; splat_scale then sets the support/spacing ratio
    spacing = (src.splat_radius / splat_scale) / 3.0 * args.grid_scale

    # Localize RSS spikes per phase (the budgets bound the tracked
    # containers, but ru_maxrss is process-wide).
    import threading

    watch_stop = threading.Event()

    def _rss_watch():
        last = 0
        while not watch_stop.wait(5):
            rss = peak_rss_bytes()
            if rss > last + (2 << 30):
                last = rss
                print(f"# rss-watch: peak {rss / 1e9:.1f} GB at "
                      f"t+{time.monotonic() - t_start:.0f}s",
                      file=sys.stderr, flush=True)
    t_start = time.monotonic()
    threading.Thread(target=_rss_watch, daemon=True).start()
    cfg = ReconstructConfig(
        fit_grid=float(spacing), fit_smooth=1.0, fit_prune=0.02,
        levels=args.levels, subsampling=3,
        **({"device_block_shift": args.device_shift}
           if args.device_shift else {}),
        max_device_splats=4 << 20,
        tile_candidates=1 << 10,
        mem_blobs=parse_capacity(args.mem_blobs),
        mem_load_splats=parse_capacity(args.mem_load_splats),
        mem_host_splats=parse_capacity(args.mem_host_splats),
        mem_mesh=parse_capacity(args.mem_mesh),
        mem_reorder=parse_capacity(args.mem_reorder),
        output_split_size=parse_capacity(args.split_size),
        checkpoint=args.checkpoint,
        progress=True,
    )
    if args.out is None:
        args.out = os.path.join(tempfile.mkdtemp(prefix="mlsgpu_ooc."),
                                "out.ply")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    t0 = time.monotonic()
    if args.resume:
        from mlsgpu_tpu_torch.pipeline.reconstruct import resume
        files = resume(args.resume, cfg, args.out)
    else:
        files = reconstruct(src, cfg, args.out, device=args.device)
        if args.checkpoint:
            files = [args.checkpoint]
    elapsed = time.monotonic() - t0
    watch_stop.set()

    rss = peak_rss_bytes()
    budget = parse_capacity(args.rss_budget)
    result = {
        "metric": "ooc points->mesh throughput",
        "splats": args.splats,
        "elapsed_s": round(elapsed, 1),
        "msplats_per_s": round(args.splats / elapsed / 1e6, 4),
        "peak_rss_gb": round(rss / 1e9, 2),
        "rss_budget_gb": round(budget / 1e9, 2),
        "rss_ok": rss <= budget,
        "output_files": len(files),
        "out": args.out,
    }
    verify_ok = True
    if args.verify and not args.checkpoint:
        # Verify the artifact we just timed (manifold sample + cross-chunk
        # continuity — the chunked-output welding contract, reference
        # src/mesher.cpp:763-852). Outside the timed window.
        from mlsgpu_tpu_torch.tools.verify_chunks import verify
        result["verify"] = verify(args.out, sample=args.verify,
                                  log=lambda s: print(s, file=sys.stderr,
                                                      flush=True))
        verify_ok = result["verify"]["ok"]
    print(json.dumps(result))
    get_registry().dump(sys.stderr)
    return 0 if (rss <= budget and verify_ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
