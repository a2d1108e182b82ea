"""The codes path's marching kernels alone on the card, for one tree or
several in turns.

    python -m mlsgpu_tpu_torch.tools.bench_marching [--roots label=path ...]
        [--splats 2000000] [--levels 6 7] [--reps 20]

On the bench cloud of tools/cloud.py, at the densest bucket of each
`--levels` (6: the main path's 256^3-corner dispatches, 7: `--levels 7`'s
512^3), each root (a checkout of the repository, `label=path`) builds the
bucket's block field as chip_smoke.py's phases 3 and 9 do (binning to
skeleton; the boundary factor 0 at 6 levels, the configuration's at 7) and
times its own ops/marching_cuda.py on it: the stage (classify, scan, the
totals' copy and wait, emit) host-paced; its two C calls on the device
alone (classify and scan; emit); each kernel alone, the median of its
kernel events in a torch.profiler trace of `--reps` stage calls. Every
root runs in a process of its own (this file as a script, the root first
on sys.path), once per `--roots` entry in the order given, so `--roots
parent=P change=. change=. parent=P` compares two trees in turns on one
card.

Prints the card's name and power limit, then one line `MARCHING {json}`
per root and level count: the kernels' ms and, from the stage's output,
the cells, vertices and listed tiles.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
KERNELS = ("march_classify_kernel", "march_scan_kernel", "march_emit_kernel")


def timing_helpers():
    """tools/bench_binning.py of this tree (event_ms, trace_events), loaded
    from its file: importing it through the package would fix the package's
    root before each process puts its own first on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "_bench_binning", os.path.join(os.path.dirname(HERE),
                                       "bench_binning.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_medians(events, names, reps: int) -> dict:
    """{name: median ms of the kernel events whose name contains it}, None
    for a name without exactly `reps` events (a trace that lost some is
    not measured)."""
    durs = {n: [] for n in names}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            for n in names:
                if n in e.get("name", ""):
                    durs[n].append(float(e["dur"]) / 1e3)
    return {n: statistics.median(d) if len(d) == reps else None
            for n, d in durs.items()}


def run_root(label: str, root: str, splats: int, levels_list, reps: int):
    """This process times `root`'s marching kernels (the root is first on
    sys.path) and prints a MARCHING line for each level count."""
    sys.path.insert(0, os.path.abspath(root))
    from mlsgpu_tpu_torch.io.splat_set import SequenceSource
    from mlsgpu_tpu_torch.ops import block, marching_cuda
    from mlsgpu_tpu_torch.pipeline.streamer import load_bucket
    from mlsgpu_tpu_torch.tools import cloud
    timing = timing_helpers()

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pts, sr = cloud.make_cloud(splats)
    src = SequenceSource(pts)
    for levels in levels_list:
        cfg = cloud.bench_config(sr, levels)
        info, _, b = cloud.densest_bucket(src, cfg)
        grid_form, valid = load_bucket(src, info, b)
        sp = torch.as_tensor(grid_form, device=dev)
        va = torch.as_tensor(valid, device=dev)
        region = tuple(int(v) for v in b.cell_hi - b.cell_lo)
        origin = tuple(int(v) for v in b.cell_lo)
        points = (torch.as_tensor(b.skeleton, device=dev) if len(b.skeleton)
                  else None)
        bf = 0.0 if levels == 6 else float(cfg.boundary_factor)
        field, _ = block.block_field(sp, va, region, origin, bf, points,
                                     levels=cfg.device_levels,
                                     subsampling=cfg.subsampling)
        del sp, va
        stage = lambda: marching_cuda.codes_image(field, region)  # noqa: E731
        marched = marching_cuda.classify(field, region)
        out = {"root": label, "levels": levels,
               "corners": int(field.shape[0]),
               "cells": marched.counts.num_cells,
               "vertices": marched.counts.num_vertices,
               "march_tiles": marched.march_tiles, "reps": reps}
        out["stage_host_paced_ms"] = timing.event_ms(stage, reps)
        out["classify_scan_call_device_ms"] = timing.event_ms(
            lambda: marching_cuda.launch_classify(field, region), reps,
            device_only=True)
        out["emit_call_device_ms"] = timing.event_ms(
            lambda: marching_cuda.emit(marched), reps, device_only=True)
        alone = kernel_medians(timing.trace_events(stage, reps), KERNELS,
                               reps)
        out.update({f"{k}_ms": v for k, v in alone.items()})
        print("MARCHING " + json.dumps(out), flush=True)
        del field, marched


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--roots", nargs="+", default=[f"this={ROOT}"],
                   help="label=path of each tree, in the order run")
    p.add_argument("--splats", type=int, default=2_000_000)
    p.add_argument("--levels", type=int, nargs="+", default=[6, 7])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one is not None:
        label, root = args.one.split("=", 1)
        run_root(label, root, args.splats, args.levels, args.reps)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    env = {k: v for k, v in os.environ.items()
           if k != "MLSGPU_TORCH_BUILD_DIR"}   # each root builds its own
    for entry in args.roots:
        rc = subprocess.run(
            [sys.executable, HERE, "--one", entry, "--splats",
             str(args.splats), "--reps", str(args.reps), "--levels",
             *(str(v) for v in args.levels)], env=env).returncode
        if rc != 0:
            print(f"bench_marching: {entry} exited {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
