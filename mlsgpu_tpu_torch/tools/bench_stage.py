"""Per-stage cost of one block step on the densest bucket of the bench
cloud, as differences of nested prefixes.

`--statistics-device` (ops/block.block_step_staged) ends every stage in a
synchronisation, so each of its numbers carries a round trip to the device.
This tool times *nested prefixes* of the real block step instead (binning;
+segments; +MLS; +faces; +skeleton; +marching classify; +marching emit; the
full step): each prefix is enqueued whole and timed over `--reps` calls, so
a stage's cost is the difference of two prefixes. The analogue of the
reference's kernel-level event profiling (--statistics-cl,
src/statistics_cl.h:43-93); port of mlsgpu_tpu/tools/bench_stage.py, whose
prefixes were fused programs (there is nothing to fuse here).

Two clocks, named in the output. `prefix_ms` is the host's
(time.perf_counter around the call and a device synchronisation): what the
prefix costs the run. On a CUDA device `prefix_event_ms` is the time
between two CUDA events around the call, recorded after the device was put
to sleep while the host queued the prefix, so the host's enqueue is hidden
up to the prefix's first own synchronisation (the counts that size the
outputs); a prefix that never synchronises is timed on the device alone.

Usage:
    python -m mlsgpu_tpu_torch.tools.bench_stage [--splats 2000000] [--reps 10]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np

#: The prefixes, in order; each ends after the stage of its name.
PREFIXES = ("binning", "segments", "mls", "faces", "skeleton", "classify",
            "march", "full")

SLEEP_CYCLES = 4_000_000  # a few ms of the device's clock


class _Stopped(Exception):
    """Raised at the end of the stage a prefix stops after."""


def _stop_after(last: str):
    @contextlib.contextmanager
    def stage(name: str):
        yield
        if name == last:
            raise _Stopped
    return stage


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--splats", type=int, default=2_000_000)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--levels", type=int, default=6)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda or cpu [%(default)s]")
    args = p.parse_args(argv)

    import torch

    from mlsgpu_tpu_torch.device import resolve_device
    from mlsgpu_tpu_torch.io.splat_set import SequenceSource
    from mlsgpu_tpu_torch.ops import block, marching
    from mlsgpu_tpu_torch.tools import cloud

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    splats, sr = cloud.make_cloud(args.splats)
    cfg = cloud.bench_config(sr, levels=args.levels)
    rb = block.resolve_readback("auto", cfg.device_levels, cfg.subsampling)
    src = SequenceSource(splats)
    info, _, b = cloud.densest_bucket(src, cfg)
    grid_form, valid = cloud.bucket_inputs(src, info, b)
    region = tuple(int(v) for v in b.cell_hi - b.cell_lo)
    origin = tuple(int(v) for v in b.cell_lo)
    has_pts = b.skeleton is not None and len(b.skeleton) > 0
    print(f"# device={dev} readback={rb} block: {len(grid_form)} splats, "
          f"region {region}, skeleton {len(b.skeleton) if has_pts else 0}",
          file=sys.stderr)

    sp = torch.as_tensor(grid_form, device=dev)
    va = torch.as_tensor(valid, device=dev)
    pts = torch.as_tensor(b.skeleton, device=dev) if has_pts else None
    bf = float(cfg.boundary_factor)
    kw = dict(levels=cfg.device_levels, subsampling=cfg.subsampling,
              fit_shape=cfg.fit_shape)

    def field(stage=None):
        return block.block_field(sp, va, region, origin, bf, pts, stage=stage,
                                 **kw)[0]

    def run(name: str):
        if name == "classify":
            return marching.classify(field(), region)
        if name == "march":
            return marching.generate_codes(field(), region)
        if name == "full":
            return block.block_step(sp, va, region, origin, bf, pts,
                                    readback=rb, **kw)
        try:
            return field(_stop_after(name))
        except _Stopped:
            return None

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    results, events = {}, {}
    prev = 0.0
    for name in PREFIXES:
        run(name)  # warm: the kernel build, the allocator's pools
        sync()
        ts, es = [], []
        for _ in range(args.reps):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(SLEEP_CYCLES)
                start.record()
                run(name)
                end.record()
                end.synchronize()
                es.append(start.elapsed_time(end))
            t0 = time.perf_counter()
            run(name)
            sync()
            ts.append(time.perf_counter() - t0)
        med = float(np.median(ts)) * 1e3
        results[name] = med
        line = (f"{name:10s} {med:8.2f} ms  (+{med - prev:7.2f} ms)  "
                f"min {min(ts) * 1e3:.2f}")
        if es:
            events[name] = float(np.median(es))
            line += f"  events {events[name]:8.2f} ms"
        print(line, flush=True)
        prev = med
    out = {"prefix_ms": results,
           "prefix_ms_clock": "host: time.perf_counter around the call and "
                              "a device synchronisation",
           "device": str(dev), "splats": int(len(grid_form)), "reps": args.reps}
    if events:
        out["prefix_event_ms"] = events
        out["prefix_event_ms_clock"] = (
            "CUDA events around the call after a device sleep: the host's "
            "enqueue hidden up to the prefix's first synchronisation")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
