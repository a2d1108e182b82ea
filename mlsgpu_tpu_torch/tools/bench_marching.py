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

Then, on the same field, the packed readback's stage as the root's block
step runs it: where the tree has ops/mesh_cuda.py, its kernels
(`mesh_image`: classify and scan, the mesh emission, the weld's sort over
the keys' top digits and its group kernel (`weld_compact_kernel` in a tree
before it), the pack kernel; two syncs) host-paced, each kernel alone (the
median of its kernel events; the sort's pass kernel summed over its
passes a call), their sum and the weld's kernels' sum; else its plain
chain; and in every tree the
plain chain (marching.generate_mesh -> weld.weld -> block.pack_readback)
host-paced. One line `MESH {json}` per root and level count.
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
#: The packed stage's kernels (ops/mesh_cuda.py).
MESH_KERNELS = ("march_classify_kernel", "march_scan_kernel",
                "march_emit_mesh_kernel", "weld_sort_histogram_kernel",
                "weld_sort_pass_kernel", "weld_group_kernel",
                "pack_readback_kernel")
#: The weld's last kernel in a tree before the group kernel.
OLD_WELD_KERNEL = "weld_compact_kernel"


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
        del marched
        print("MESH " + json.dumps(mesh_stage(
            label, levels, field, region, origin, cfg.subsampling, reps,
            timing)), flush=True)
        del field


def mesh_stage(label, levels, field, region, origin, subsampling, reps,
               timing) -> dict:
    """The packed stage of this process's tree on a block's field: its
    kernels where it has them (each alone, their sum, the stage
    host-paced), else its plain chain; and the plain chain host-paced."""
    from mlsgpu_tpu_torch.ops import block, marching, weld

    def plain():
        m = marching.generate_mesh(field, region, origin)
        w = weld.weld(m.vertices, m.key_hi, m.key_lo, m.triangles)
        return block.pack_readback(w, origin, block.pack_format(
            levels, subsampling, w.num_vertices))

    out = {"root": label, "levels": levels, "reps": reps,
           "plain_chain_ms": timing.event_ms(plain, reps)}
    try:
        from mlsgpu_tpu_torch.ops import mesh_cuda
    except ImportError:      # a tree before the mesh kernels
        out.update(path="plain", stage_host_paced_ms=out["plain_chain_ms"])
        return out
    stage = lambda: mesh_cuda.mesh_image(  # noqa: E731
        field, region, origin, levels, subsampling)
    res = stage()
    passes = mesh_cuda.sort_passes(mesh_cuda.key_bits(res.mesh.axis_bits))
    out.update(path="kernels", vertices=res.mesh.num_vertices,
               welded=res.welded.num_vertices,
               indices=res.mesh.num_indices, sort_passes=passes,
               index_mode=res.fmt.index_mode,
               stage_host_paced_ms=timing.event_ms(stage, reps))
    events = timing.trace_events(stage, reps)
    names = [k for k in MESH_KERNELS if k != "weld_sort_pass_kernel"]
    if not any("weld_group_kernel" in e.get("name", "") for e in events):
        names[names.index("weld_group_kernel")] = OLD_WELD_KERNEL
    alone = kernel_medians(events, names, reps)
    alone["weld_sort_pass_kernel"] = timing.kernel_event_ms(
        events, ("weld_sort_pass_kernel",), reps, passes)
    out.update({f"{k}_ms": v for k, v in alone.items()})
    known = [v for v in alone.values() if v is not None]
    out["kernels_ms"] = sum(known) if len(known) == len(alone) else None
    welds = [v for k, v in alone.items() if k.startswith("weld")]
    out["weld_kernels_ms"] = None if None in welds else sum(welds)
    return out


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
