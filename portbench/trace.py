"""The device trace of one job and what the benchmark reads from it.

`traced_job` runs one job under torch.profiler (the host's and the card's
activity, as the program's own tools trace) and reduces the
Chrome trace it exports to a `TraceSummary`: the card's busy time (the
union of its kernel, copy and set intervals), each kernel's events and
total time by name, and the card's idle gaps. The program's `--timeplot`
actions of the same job name each gap by what the host was doing then;
a short spin kernel launched just before the job ties the trace's clock to
the host's.

The profiler has been seen to lose kernel events in long processes, so
`lost_launches` compares the kernel events of each of the program's
hand-written kernels with the launches the program counted for that job
(mlsgpu_tpu_torch/ops/launches.py): a job whose trace lost any is traced
again, never read.
"""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Tuple

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_ANCHOR = "spin_kernel"


@dataclass
class TraceSummary:
    """What one traced job's trace says (all times in seconds)."""
    wall_s: float                      # the job on the host's clock
    busy_s: float                      # union of the card's intervals
    kernel_s: Dict[str, float] = field(default_factory=dict)     # by name
    kernel_events: Dict[str, int] = field(default_factory=dict)
    kernels: Dict[str, float] = field(default_factory=dict)      # short names
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def short_name(name: str) -> str:
    """A kernel's name without its namespace, return type, template or
    arguments."""
    name = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    name = re.sub(r"<.*", "", name)
    return name.split()[-1] if name.split() else name


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint intervals that cover `spans`, in order."""
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def read_timeplot(path: str) -> List[Tuple[str, str, float, float]]:
    """The EVENT lines of a `--timeplot` file: (worker, action, start,
    stop) in seconds of time.monotonic."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 5 and parts[0] == "EVENT":
                out.append((parts[1], parts[2], float(parts[3]),
                            float(parts[4])))
    return out


def host_action(actions, phases, t: float) -> str:
    """What the host was doing at monotonic time `t`: the timeplot actions
    running then, by worker kind and action (`mesher:mesher`,
    `decode:decode`); else the job's phase then (`phases`: (name, start,
    stop) from the job's start and the program's phase timers), or
    `none`."""
    names = sorted({f"{w.split('.')[0]}:{a}" for w, a, lo, hi in actions
                    if lo <= t < hi})
    if names:
        return "+".join(names)
    return next((name for name, lo, hi in phases if lo <= t < hi), "none")


def job_phases(lo: float, hi: float, spent: Mapping[str, float]):
    """The phases of a job that ran from `lo` to `hi` (monotonic seconds)
    that the program times but does not plot, laid out in the order
    `reconstruct` runs them: the blob pass and bucketing from the start,
    the write at the end. `spent` holds each phase timer's seconds."""
    p0 = spent.get("pass0.time", 0.0)
    b = spent.get("bucket.time", 0.0)
    w = spent.get("write.time", 0.0)
    return [("driver:blob_pass", lo, lo + p0),
            ("driver:bucketing", lo + p0, lo + p0 + b),
            ("driver:write", hi - w, hi)]


def reduce_trace(trace: Mapping, job_lo: float, job_hi: float,
                 anchor_mono: float, actions, phases=()) -> TraceSummary:
    """Reduce a Chrome trace of one job (host times `job_lo`..`job_hi`,
    monotonic seconds; the anchor kernel launched at `anchor_mono`)."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("cat") in _DEVICE
              and "dur" in e]
    anchor = [e for e in events if _ANCHOR in e.get("name", "")]
    events = [e for e in events if _ANCHOR not in e.get("name", "")]
    # trace microseconds -> monotonic seconds, through the anchor kernel
    if anchor:
        shift = anchor_mono - float(anchor[0]["ts"]) * 1e-6
    else:
        shift = None
    kernel_s: Dict[str, float] = {}
    kernel_events: Dict[str, int] = {}
    spans = []
    for e in events:
        lo = float(e["ts"]) * 1e-6
        hi = lo + float(e["dur"]) * 1e-6
        spans.append((lo, hi))
        name = e["name"] if e.get("cat") == "kernel" else e.get("cat")
        kernel_s[name] = kernel_s.get(name, 0.0) + (hi - lo)
        kernel_events[name] = kernel_events.get(name, 0) + 1
    kernels: Dict[str, float] = {}
    for name, sec in kernel_s.items():
        kernels[short_name(name)] = kernels.get(short_name(name), 0.0) + sec
    merged = union(spans)
    busy = sum(hi - lo for lo, hi in merged)
    gaps: List[Tuple[str, float]] = []
    if shift is not None:
        edges = ([job_lo - shift] + [x for span in merged for x in span]
                 + [job_hi - shift])
        for lo, hi in zip(edges[0::2], edges[1::2]):
            if hi > lo:
                gaps.append((host_action(actions, phases,
                                         (lo + hi) / 2 + shift),
                             hi - lo))
        gaps.sort(key=lambda g: -g[1])
    return TraceSummary(wall_s=job_hi - job_lo, busy_s=busy,
                        kernel_s=kernel_s, kernel_events=kernel_events,
                        kernels=kernels, idle_gaps=gaps)


def lost_launches(summary: TraceSummary, launched: Mapping[str, int]
                  ) -> Dict[str, Tuple[int, int]]:
    """The program's kernels whose events in the trace differ from the
    launches it counted: {kernel: (launched, traced)}."""
    lost = {}
    for k, n in launched.items():
        seen = sum(c for name, c in summary.kernel_events.items()
                   if re.search(rf"(^|[^A-Za-z0-9_]){k}_kernel($|[^A-Za-z0-9_])",
                                name))
        if seen != n:
            lost[k] = (int(n), int(seen))
    return lost


def traced_job(run_job: Callable[[], None], workdir: str, tag: str,
               launch_counts: Callable[[], Dict[str, int]]):
    """Run one job under the profiler, with the program's timeplot on.
    Returns (TraceSummary, the launches the program counted in it)."""
    import torch
    import torch.profiler as tp
    from mlsgpu_tpu_torch.utils import timeplot
    from mlsgpu_tpu_torch.utils.statistics import get_registry

    timers = ("pass0.time", "bucket.time", "write.time")

    def spent():
        return {k: get_registry().timer(k).sum for k in timers}

    plot = os.path.join(workdir, f"{tag}.timeplot")
    path = os.path.join(workdir, f"{tag}.trace.json")
    before, before_s = launch_counts(), spent()
    timeplot.init(plot)
    try:
        with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                    tp.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            anchor = time.monotonic()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            lo = time.monotonic()
            run_job()
            torch.cuda.synchronize()
            hi = time.monotonic()
    finally:
        timeplot.init(None)
    after, after_s = launch_counts(), spent()
    phases = job_phases(lo, hi, {k: after_s[k] - before_s[k] for k in timers})
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    summary = reduce_trace(trace, lo, hi, anchor, read_timeplot(plot),
                           phases)
    os.remove(plot)
    return summary, {k: after[k] - before[k] for k in after}
