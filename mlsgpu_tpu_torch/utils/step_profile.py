"""Block-step traces with torch.profiler, off unless asked for.

With the environment variable MLSGPU_PROFILE_STEPS=DIR set, every device
worker (the thread of a one-worker run, and each worker process of a run
with more) traces its own block steps FIRST .. FIRST + COUNT - 1 with
torch.profiler (the card's activity too where there is a card) and
writes, after its last traced step or when it ends:

    DIR/<worker>.<pid>.trace.json.gz   the Chrome trace
    DIR/<worker>.<pid>.json            `summarize` of it

`python -m mlsgpu_tpu_torch.utils.step_profile TRACE.json.gz ...` prints
the summary of each trace again, one JSON line each.

The first FIRST steps of a worker are left out: they pay the caching
allocator's first allocations. The variable reaches worker processes
through the environment of the worker server, which the command line
starts, so it is set before the command starts (tools/bench_queues
--profile does so).
"""

from __future__ import annotations

import bisect
import contextlib
import gzip
import json
import os
import shutil
import sys
from typing import Dict, List, Tuple

import torch

ENV = "MLSGPU_PROFILE_STEPS"
FIRST = 2
COUNT = 4

#: The trace's name for a block step's span (record_function).
STEP = "block_step"

#: Runtime calls in which the host waits for the card.
_SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")
_RUNTIME = ("cuda_runtime", "cuda_driver")
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_us(spans: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def _outermost(ops: List[Dict]) -> Tuple[List[float], List[Dict]]:
    """The operators of one thread that no other operator encloses, in
    time order, and their start times."""
    top: List[Dict] = []
    end = float("-inf")
    for o in sorted(ops, key=lambda o: (float(o["ts"]), -float(o["dur"]))):
        if float(o["ts"]) >= end:
            top.append(o)
            end = float(o["ts"]) + float(o["dur"])
    return [float(o["ts"]) for o in top], top


def summarize(trace: Dict) -> Dict:
    """Per block step (milliseconds, means over the traced steps) from a
    Chrome trace of torch.profiler: `wall_ms`, the step's span on the host
    clock; `sync_ms`, the host's time in calls that wait for the card
    (cuda*Synchronize, cudaMemcpy) on the step's thread; `dispatch_ms`,
    wall less sync, the host issuing work; `device_busy_ms`, the union of
    the card's kernel, copy and set intervals over the traced window, per
    step; `launches` and `sync_calls` per step; `sync_ms_by_call`; and
    `syncs_by_op`, the syncs per step and their ms per step by the
    outermost PyTorch operator that made them (`aten::to` for a copy,
    `aten::item` for a scalar read)."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == STEP]
    n = len(steps)
    if not n:
        return {"steps": 0}
    spans = [(float(s["ts"]), float(s["ts"]) + float(s["dur"]))
             for s in steps]
    tids = {s.get("tid") for s in steps}
    runtime = [e for e in events if e.get("cat") in _RUNTIME
               and any(lo <= float(e["ts"]) < hi for lo, hi in spans)]
    if any(e.get("tid") in tids for e in runtime):
        runtime = [e for e in runtime if e.get("tid") in tids]
    starts, top = _outermost([e for e in events if e.get("cat") == "cpu_op"
                              and e.get("tid") in tids])
    sync: Dict[str, float] = {}
    by_op: Dict[str, List[float]] = {}
    for e in runtime:
        if e["name"] not in _SYNC:
            continue
        sync[e["name"]] = sync.get(e["name"], 0.0) + float(e["dur"])
        i = bisect.bisect_right(starts, float(e["ts"])) - 1
        op = ("(none)" if i < 0 or float(top[i]["ts"]) + float(top[i]["dur"])
              < float(e["ts"]) + float(e["dur"]) else top[i]["name"])
        count = by_op.setdefault(op, [0.0, 0.0])
        count[0] += 1
        count[1] += float(e["dur"])
    wall = sum(hi - lo for lo, hi in spans)
    busy = _union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in events if e.get("cat") in _DEVICE])
    per = 1e-3 / n
    return {"steps": n, "wall_ms": wall * per,
            "sync_ms": sum(sync.values()) * per,
            "dispatch_ms": (wall - sum(sync.values())) * per,
            "device_busy_ms": busy * per,
            "launches": sum("LaunchKernel" in e["name"]
                            for e in runtime) / n,
            "sync_calls": sum(e["name"] in _SYNC for e in runtime) / n,
            "sync_ms_by_call": {k: v * per for k, v in sorted(sync.items())},
            "syncs_by_op": {k: [c / n, ms * per]
                            for k, (c, ms) in sorted(by_op.items())}}


class StepProfiler:
    """One worker's traced steps (module docstring); inert when the
    environment does not ask for them. Used from the worker's own
    thread: `step()` around each block step, `close()` when it ends."""

    def __init__(self, name: str):
        self.dir = os.environ.get(ENV) or None
        self.name = name
        self.steps = 0
        self._prof = None

    @contextlib.contextmanager
    def step(self):
        traced = self.dir is not None and FIRST <= self.steps < FIRST + COUNT
        self.steps += 1
        if not traced:
            yield
            return
        if self._prof is None:
            import torch.profiler as tp
            acts = [tp.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(tp.ProfilerActivity.CUDA)
            self._prof = tp.profile(activities=acts)
            self._prof.__enter__()
        with torch.profiler.record_function(STEP):
            yield
        if self.steps == FIRST + COUNT:
            self.close()

    def close(self) -> None:
        """Stop the trace, if one runs, and write its files."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        base = os.path.join(self.dir, f"{self.name}.{os.getpid()}")
        prof.export_chrome_trace(base + ".trace.json")
        with open(base + ".trace.json") as f:
            summary = dict(summarize(json.load(f)), worker=self.name,
                           pid=os.getpid())
        with open(base + ".trace.json", "rb") as src, \
                gzip.open(base + ".trace.json.gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.remove(base + ".trace.json")
        with open(base + ".json", "w") as f:
            json.dump(summary, f)


def main(argv=None) -> int:
    for path in (sys.argv[1:] if argv is None else argv):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            print(json.dumps(dict(summarize(json.load(f)), trace=path)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
