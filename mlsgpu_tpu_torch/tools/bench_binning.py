"""The binning kernels alone on the card, for one tree or several in turns.

    python -m mlsgpu_tpu_torch.tools.bench_binning [--roots label=path ...]
        [--splats 2000000] [--levels 6 7] [--reps 20]

On the bench cloud of tools/cloud.py, at the densest bucket of each
`--levels` (6: the main path's 256^3-corner dispatches, 7: `--levels 7`'s
512^3), each root (a checkout of the repository, `label=path`) times its
own binning stage through its own ops/binning_cuda.py: the key pass,
the entry gather, the tile segments and, where the tree has it, the radix
sort (`sort_keys`), each call host-paced and on the device alone (CUDA
events, the card first sleeping while the host queues the call), and each
kernel alone (the kernel events of a torch.profiler trace; the segments
sum their kernels: the bounds kernel and the gather where the tree has
both, each also alone; the sort's histogram kernel and its pass kernels
over a call), beside `torch.sort` of the keys and `torch.searchsorted` on
the segments' prebuilt queries. Every
root runs in a process of its own (this file as a script, the root first
on sys.path), once per `--roots` entry in the order given, so `--roots
parent=P change=. change=. parent=P` compares two trees in turns on one
card.

Prints the card's name and power limit, then one line `BINNING {json}`
per root and level count.

The timing helpers here (event_ms, trace_events, kernel_ms,
segment_queries) are also chip_smoke.py's. They import nothing of the
package at module level, so that each root's process takes the root's
own.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
SLEEP_CYCLES = 4_000_000   # ~2 ms of the card's clock: longer than any
#                            host enqueue of one timed call


def event_ms(fn, reps: int, device_only: bool = False,
             sleep_cycles: int = SLEEP_CYCLES) -> float:
    """Median CUDA-event time of fn() after one warm-up call. By default
    the events also see the host: work the card finishes faster than the
    host can queue it is timed at the host's pace. device_only: the card
    first sleeps `sleep_cycles` while the host queues fn's work, so the
    events time the device's work alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_event_ms(events, names, reps: int, launches: int = 1):
    """Device ms a call spends in the kernels whose name contains one of
    `names`, from the events of a Chrome trace of `reps` calls that each
    launch every named kernel `launches` times: the sum over `names` of
    its kernel events' durations over `reps`. None unless each name has
    exactly `reps * launches` kernel events: a trace that lost some is not
    measured."""
    per = {n: [] for n in names}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            for n in names:
                if n in e.get("name", ""):
                    per[n].append(float(e["dur"]))
    if any(len(d) != reps * launches for d in per.values()):
        return None
    return sum(sum(d) for d in per.values()) / reps / 1e3


def trace_events(fn, reps: int):
    """The events of a torch.profiler trace (the host's and the card's
    activity) of `reps` calls of fn after one warm-up call."""
    import torch.profiler as tp
    fn()
    torch.cuda.synchronize()
    with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                tp.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="bench_binning.") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def kernel_ms(fn, names, reps: int, launches: int = 1):
    """kernel_event_ms of a trace of `reps` calls of fn (trace_events),
    each launching every named kernel `launches` times; `names` a kernel
    name or a tuple of them."""
    names = (names,) if isinstance(names, str) else tuple(names)
    return kernel_event_ms(trace_events(fn, reps), names, reps, launches)


def segment_queries(min_s: int, max_s: int, tpa: int, device):
    """The node keys binning.tile_segments searches for, each (tile,
    level)'s node and the next key, (2 * levels, tpa^3) int64: the queries
    of one torch.searchsorted call that computes the segments."""
    from mlsgpu_tpu_torch.ops import binning, morton
    t = torch.arange(tpa, dtype=torch.int64, device=device)
    tz, ty, tx = torch.meshgrid(t, t, t, indexing="ij")
    code = morton.encode(tx.reshape(-1), ty.reshape(-1), tz.reshape(-1))
    offs = binning.level_offsets(min_s, max_s)
    return torch.stack([q for li in range(max_s - min_s + 1) for q in (
        (code >> (3 * (min_s - 3 + li))) + int(offs[li]),
        (code >> (3 * (min_s - 3 + li))) + int(offs[li]) + 1)])


def run_root(label: str, root: str, splats: int, levels_list, reps: int):
    """This process times `root`'s binning kernels (the root is first on
    sys.path) and prints a BINNING line for each level count."""
    sys.path.insert(0, os.path.abspath(root))
    from mlsgpu_tpu_torch.io.splat_set import SequenceSource
    from mlsgpu_tpu_torch.ops import binning, binning_cuda
    from mlsgpu_tpu_torch.pipeline.streamer import load_bucket
    from mlsgpu_tpu_torch.tools import cloud

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
        origin = tuple(int(v) for v in b.cell_lo)
        min_s, max_s = cfg.subsampling, levels + cfg.subsampling - 1
        tpa = 1 << (max_s - 3)
        keys = binning_cuda.splat_keys(sp, va, origin, min_s, max_s)
        sorted_keys, perm = torch.sort(keys, stable=True)
        queries = segment_queries(min_s, max_s, tpa, dev)
        hand_sort = hasattr(binning_cuda, "sort_keys")
        two = hasattr(binning_cuda, "segments_and_bounds")
        segments = (("tile_bounds_kernel", "tile_segments_kernel") if two
                    else ("tile_segments_kernel",))
        calls = {
            "keys": (lambda: binning_cuda.splat_keys(
                sp, va, origin, min_s, max_s), "bin_keys_kernel"),
            "entries": (lambda: binning_cuda.entry_rows(sp, perm),
                        "bin_entries_kernel"),
            "segments": (lambda: binning_cuda.tile_segments(
                sorted_keys, min_s, max_s, tpa), segments)}
        out = {"root": label, "levels": levels, "splats": int(sp.shape[0]),
               "entries": int(sorted_keys.numel()), "tiles": tpa ** 3}
        for name, (call, kernels) in calls.items():
            out[f"{name}_call_host_paced_ms"] = event_ms(call, reps)
            out[f"{name}_call_device_ms"] = event_ms(call, reps,
                                                     device_only=True)
            out[f"{name}_kernel_ms"] = kernel_ms(call, kernels, reps)
        if two:
            for kernel in segments:
                out[f"{kernel}_ms"] = kernel_ms(calls["segments"][0], kernel,
                                                reps)
        if hand_sort:
            # the sort's C call (a memset, the histogram kernel, a pass
            # kernel a digit), each of its kernels alone over a call
            sort = (lambda: binning_cuda.sort_keys(keys, min_s, max_s))
            passes = len(binning.sort_digits(min_s, max_s))
            out["sort_passes"] = passes
            out["sort_call_host_paced_ms"] = event_ms(sort, reps)
            out["sort_call_device_ms"] = event_ms(sort, reps,
                                                  device_only=True)
            events = trace_events(sort, reps)
            out["bin_sort_histogram_kernel_ms"] = kernel_event_ms(
                events, ("bin_sort_histogram_kernel",), reps)
            out["bin_sort_pass_kernel_ms"] = kernel_event_ms(
                events, ("bin_sort_pass_kernel",), reps, passes)
        out["sort_device_ms"] = event_ms(
            lambda: torch.sort(keys, stable=True), reps, device_only=True)
        out["searchsorted_device_ms"] = event_ms(
            lambda: torch.searchsorted(sorted_keys, queries), reps,
            device_only=True)
        print("BINNING " + json.dumps(out), flush=True)


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
            print(f"bench_binning: {entry} exited {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
