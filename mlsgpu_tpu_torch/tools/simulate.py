"""Discrete-event simulator of the streaming pipeline, driven by a recorded
timeplot trace.

Equivalent of the reference's utils/simulate.py: replay the per-block stage
durations captured in a --timeplot trace against a *hypothetical* pipeline
configuration (loader thread count, in-flight window, device count) to
predict throughput without re-running the reconstruction. Use it to answer
"would a deeper window / second loader / more chips help?".

Pipeline model (pipeline/streamer.py): L loader threads feed a bounded
queue of capacity W+1; the streamer runs D devices x T queues, one worker
per (device, queue), each processing one block at a time, and `--devices`
here is that number of workers, D x T (the model deals the blocks
round-robin where the streamer's free worker pulls the next one, the same
for blocks of equal cost); a single mesher consumes results in the
loader's order. A trace of a multi-worker run carries one worker per
queue (`device.<card>.<queue>`); its `compute` spans are read together.

Usage:
    python -m mlsgpu_tpu_torch.tools.simulate trace.txt [--window N]
        [--devices N] [--loaders N]
"""

from __future__ import annotations

import argparse
import heapq
import sys
from collections import defaultdict
from typing import List


def parse_blocks(path: str):
    """Per-block durations of each stage, in event order per action."""
    per_action = defaultdict(list)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 5 or parts[0] != "EVENT":
                continue
            _, worker, action, start, stop = parts
            per_action[action].append((float(start), float(stop) - float(start)))
    blocks = {}
    for action, spans in per_action.items():
        spans.sort()  # by start time = block order
        blocks[action] = [d for _, d in spans]
    return blocks


def simulate(load: List[float], compute: List[float], mesh: List[float],
             loaders: int = 1, window: int = 2, devices: int = 1) -> float:
    """Event-driven replay; returns the simulated makespan in seconds.

    Backpressure: at most window+1 loaded blocks may be unconsumed by
    dispatch (the bounded queue), and results are consumed in order.
    """
    n = max(len(load), len(compute), len(mesh))

    def dur(xs, i):
        return xs[i] if i < len(xs) else (xs[-1] if xs else 0.0)

    load_done = [0.0] * n
    # Loader threads pick blocks in order; each thread is sequential. A
    # block may not finish loading before queue space frees: space frees
    # when dispatch pops, which we approximate by delaying the *start* of
    # load i until block i - (window + 1) has been dispatched.
    dispatch_time = [0.0] * n
    dev_free = [0.0] * devices
    loader_free = [0.0] * loaders
    mesher_free = 0.0
    result_ready = [0.0] * n
    done = 0.0

    for i in range(n):
        li = i % loaders
        start = loader_free[li]
        if i - (window + 1) >= 0:
            start = max(start, dispatch_time[i - (window + 1)])
        load_done[i] = start + dur(load, i)
        loader_free[li] = load_done[i]

        di = i % devices
        dispatch_time[i] = max(load_done[i], dev_free[di])
        result_ready[i] = dispatch_time[i] + dur(compute, i)
        dev_free[di] = result_ready[i]

        # window forcing: the consumer waits for result i - window before
        # dispatching further; modeled by the mesher consuming in order.
        mesher_free = max(mesher_free, result_ready[i]) + dur(mesh, i)
        done = mesher_free
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="simulate", description=__doc__.split("\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--window", type=int, default=2)
    ap.add_argument("--devices", type=int, default=1,
                    help="device workers: devices x queues per device")
    ap.add_argument("--loaders", type=int, default=1)
    args = ap.parse_args(argv)

    blocks = parse_blocks(args.trace)
    load = blocks.get("load", [])
    compute = blocks.get("compute", [])
    mesh = blocks.get("mesher", [])
    n = max(len(load), len(compute), len(mesh))
    if n == 0:
        print("no EVENT records found", file=sys.stderr)
        return 1
    base = simulate(load, compute, mesh)
    hypo = simulate(load, compute, mesh, loaders=args.loaders,
                    window=args.window, devices=args.devices)
    print(f"{n} blocks; stage totals: load {sum(load):.2f}s, "
          f"compute {sum(compute):.2f}s, mesher {sum(mesh):.2f}s")
    print(f"simulated makespan (loaders=1, window=2, devices=1): {base:.2f}s")
    print(f"simulated makespan (loaders={args.loaders}, window={args.window}, "
          f"devices={args.devices}): {hypo:.2f}s "
          f"({base / hypo if hypo else 0:.2f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
