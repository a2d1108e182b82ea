"""Several queues and cards against one queue, through the command line as
users run it.

Makes the bench cloud of tools/cloud.py at each size, writes it as a PLY,
then runs `python -m mlsgpu_tpu_torch --statistics --device-threads Q ...`
on it as a subprocess of its own for every queue count, and reads the
run's statistics back from its standard output. With several `--roots`
(checkouts of the repository, `label=path`) each (cloud, queues) is run
once per root in the order given, so `--roots parent=P change=. change=.
parent=P` compares two trees in turns on the same clouds.

For every run it prints one line `RUN {json}`: the wall time of the
subprocess, its imports before the run (`cli.importTime`) and its own
phases; the worker processes' start split into
its stages (worker_start / worker_preload's clock marks: interpreter up,
torch, the step's modules, the CUDA context, the kernel library) and
`workers.readyWait`; the parent's host time per block by stage (loader
read and frame conversion, the shared-memory copy, a proxy's wait for its
process, a worker's wait for a free slot of its window and for a loaded
block, decode, mesher, the consumer's busy time and the producer's wait for
it); what sets pass 1's pace: the consumer thread's busy share of
`pass1.time` (its `consumer.busy`; in a tree that does not record it, decode
and mesher, which its consumer ran), the producer's wait share, and the
workers' slot wait summed; the blocks per worker; the launches of
every hand kernel, by name (ops/launches.py), and the blocks with skeleton
points; a
digest of the mesh; and any process of the run's session still alive once
it has exited (which is then killed). A statistic a tree does not record
is null. The last line is `SUMMARY {json}` with each run's wall time
against the one-queue runs of its root and cloud on the first `--device`.

With `--profile DIR`, after the timed runs, each root of `--profile-roots`
(by default `--roots`) runs the first cloud once more on the first
`--device` for each of `--profile-queues`, with
MLSGPU_PROFILE_STEPS set (utils/step_profile.py): every worker traces its
block steps 3-6 with torch.profiler, and a line `PROFILE {json}` gives each
worker's split of a step into dispatch, sync wait and card busy time (the
traces stay in DIR).

Usage:
    python -m mlsgpu_tpu_torch.tools.bench_queues [--splats 2000000 6000000]
        [--queues 1 2 4] [--big-queues 1 2] [--device cuda:0 [cuda]]
        [--roots label=path ...] [--workdir DIR] [--warmup-splats N]
        [--profile DIR [--profile-queues 1 2] [--profile-roots ...]]

`--big-queues` are the queue counts of every cloud after the first.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: The worker start's stages, as (label, statistic), means per process
#: that paid them; the first three are the process's imports.
START = [("up_s", "workers.upTime"), ("torch_s", "workers.torchTime"),
         ("modules_s", "workers.moduleTime"),
         ("import_s", "workers.importTime"), ("cuda_s", "workers.cudaTime"),
         ("kernel_s", "workers.kernelTime"), ("start_s", "workers.startTime")]

#: The parent's host stages of a block, as (label, statistic), seconds per
#: block; the last three are the worker side's, for comparison.
PER_BLOCK = [("load_s", "loader.time"), ("read_s", "loader.read"),
             ("convert_s", "loader.convert"),
             ("send_copy_s", "workers.sendCopy"),
             ("proxy_wait_s", "workers.proxyWait"),
             ("slot_wait_s", "workers.slotWait"),
             ("block_wait_s", "workers.blockWait"),
             ("decode_s", "readback.decode"), ("mesher_s", "mesher.time"),
             ("consumer_busy_s", "consumer.busy"),
             ("consumer_wait_s", "consumer.wait"),
             ("readback_wait_s", "readback.wait"),
             ("worker_convert_s", "workers.convert"),
             ("h2d_s", "dispatch.h2d"), ("device_s", "device.time"),
             ("copy_s", "readback.copy")]


def bench_args(spacing: float) -> List[str]:
    """The bench configuration's options (tools/cloud.bench_config)."""
    return ["--fit-grid", repr(spacing), "--fit-smooth", "1", "--levels",
            "6", "--subsampling", "3", "--max-device-splats", "4194304",
            "--tile-candidates", "384", "--no-progress"]


def session_pids(sid: int) -> List[int]:
    """The processes of session `sid` (Linux /proc)."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if int(fields[3]) == sid:
            out.append(int(name))
    return out


def _sum(stats: Dict, name: str) -> Optional[float]:
    d = stats.get(name)
    return None if d is None else float(d["sum"])


def _mean(stats: Dict, name: str) -> Optional[float]:
    d = stats.get(name)
    return None if d is None or not d["n"] else float(d["sum"]) / d["n"]


def _count(stats: Dict, name: str) -> Optional[int]:
    d = stats.get(name)
    return None if d is None else int(d["total"])


def pace(stats: Dict) -> Dict:
    """What sets pass 1's pace (module docstring), as shares of
    `pass1.time` and seconds."""
    pass1 = _sum(stats, "pass1.time")
    busy = _sum(stats, "consumer.busy")
    if busy is None:     # a tree whose consumer decoded and meshed
        parts = [_sum(stats, n) for n in ("readback.decode", "mesher.time")]
        busy = None if None in parts else sum(parts)
    wait = _sum(stats, "consumer.wait")
    return {"consumer_busy_share": (None if busy is None or not pass1
                                    else busy / pass1),
            "consumer_wait_share": (None if wait is None or not pass1
                                    else wait / pass1),
            "consumer_busy_s": busy, "consumer_wait_s": wait,
            "slot_wait_s": _sum(stats, "workers.slotWait"),
            "block_wait_s": _sum(stats, "workers.blockWait"),
            "decode_threads": _count(stats, "readback.decodeThreads")}


def run_cli(root: str, ply_path: str, spacing: float,
            extra: Sequence[str], timeout: float = 900.0,
            env: Optional[Dict[str, str]] = None) -> Dict:
    """One run of the command line of the checkout at `root` on `ply_path`
    in a session of its own, with `env` added to this process's
    environment; the run's numbers (module docstring). Raises when it
    exits non-zero."""
    from mlsgpu_tpu_torch.io import ply
    from mlsgpu_tpu_torch.ops import launches
    from mlsgpu_tpu_torch.tools.analyze_stats import parse

    out = ply_path[:-4] + ".out.ply"
    cmd = [sys.executable, "-m", "mlsgpu_tpu_torch", *bench_args(spacing),
           *extra, "--statistics", "-o", out, ply_path]
    env = dict(os.environ, **(env or {}), PYTHONPATH=root)
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        so, se = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        so, se = proc.communicate()
    wall = time.monotonic() - t0
    left = session_pids(proc.pid)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(extra)} in {root}: exit code "
                           f"{proc.returncode}: {se[-3000:]}")
    stats = parse(so.splitlines())
    verts, tris = ply.read_mesh(out)
    os.remove(out)
    blocks = _count(stats, "bucket.count") or 0
    per_worker = {k[len("device.blocks."):]: v["total"]
                  for k, v in sorted(stats.items())
                  if k.startswith("device.blocks.")}
    res = {"wall_s": wall, "import_s": _sum(stats, "cli.importTime"),
           "run_s": _sum(stats, "run.time"),
           "pass0_s": _sum(stats, "pass0.time"),
           "bucket_s": (_sum(stats, "bucket.time") or 0.0)
           + (_sum(stats, "bucket.skeletonTime") or 0.0),
           "pass1_s": _sum(stats, "pass1.time"),
           "write_s": _sum(stats, "write.time"),
           "blocks": blocks,
           "launches": {k: _count(stats, name)
                        for k, name in launches.KERNELS.items()},
           "skeleton_blocks": _count(stats, "bucket.skeletonBlocks"),
           "spawned": _count(stats, "workers.spawned") or 0,
           "main_imported": _count(stats, "workers.mainImported"),
           "ready_wait_s": _sum(stats, "workers.readyWait"),
           "start": {k: _mean(stats, n) for k, n in START},
           "start_samples": {k: (stats.get(n) or {}).get("n")
                             for k, n in START},
           "per_block": {k: (None if _sum(stats, n) is None or not blocks
                             else _sum(stats, n) / blocks)
                         for k, n in PER_BLOCK},
           "pace": pace(stats),
           "workers": per_worker,
           "vertices": len(verts), "triangles": len(tris),
           "digest": hashlib.sha256(verts.tobytes() + tris.tobytes())
           .hexdigest(),
           "left_running": left}
    return res


def read_profiles(trace_dir: str) -> Dict[str, Dict]:
    """The step summaries (utils/step_profile.summarize) in `trace_dir`,
    by worker."""
    out = {}
    for name in sorted(os.listdir(trace_dir)):
        if name.endswith(".json") and not name.endswith(".trace.json"):
            with open(os.path.join(trace_dir, name)) as f:
                summary = json.load(f)
            out[summary["worker"]] = summary
    return out


def profile_runs(args, roots, n: int, path: str, spacing: float) -> None:
    """The traced runs of --profile: one line PROFILE {json} each."""
    dev = args.device[0]
    for q in args.profile_queues:
        for label, root in dict(roots).items():
            trace_dir = os.path.abspath(os.path.join(
                args.profile, f"{label}_{n}_{dev.replace(':', '')}_{q}"))
            os.makedirs(trace_dir, exist_ok=True)
            res = run_cli(os.path.abspath(root), path, spacing,
                          ["--device", dev, "--device-threads", str(q)],
                          env={"MLSGPU_PROFILE_STEPS": trace_dir})
            print("PROFILE " + json.dumps({
                "root": label, "splats": n, "device": dev, "queues": q,
                "wall_s": res["wall_s"], "pass1_s": res["pass1_s"],
                "digest": res["digest"], "trace_dir": trace_dir,
                "workers": read_profiles(trace_dir)}), flush=True)


def write_cloud(n: int, workdir: str):
    """The bench cloud of `n` splats as a PLY in `workdir`: (path, grid
    spacing)."""
    from mlsgpu_tpu_torch.io import ply
    from mlsgpu_tpu_torch.tools import cloud

    splats, sr = cloud.make_cloud(n)
    path = os.path.join(workdir, f"cloud_{n}.ply")
    ply.write_splats_ply(path, splats)
    return path, float(cloud.bench_config(sr).fit_grid)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--splats", type=int, nargs="+",
                   default=[2_000_000, 6_000_000])
    p.add_argument("--queues", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--big-queues", type=int, nargs="+", default=[1, 2])
    p.add_argument("--device", nargs="+", default=["cuda:0"],
                   help="--device of the runs; several: each queue count "
                        "on each, e.g. cuda:0 cuda for one card against "
                        "every card [%(default)s]")
    p.add_argument("--roots", nargs="+", default=[f"this={ROOT}"],
                   metavar="LABEL=PATH")
    p.add_argument("--workdir", default=None)
    p.add_argument("--warmup-splats", type=int, default=100_000,
                   help="a one-queue run of this many splats per root "
                        "first, so that no measured run builds a library "
                        "(0: none) [%(default)s]")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="then trace the block steps of a run per root and "
                        "--profile-queues count into DIR (module docstring)")
    p.add_argument("--profile-queues", type=int, nargs="+", default=[1, 2])
    p.add_argument("--profile-roots", nargs="+", default=None,
                   metavar="LABEL=PATH")
    args = p.parse_args(argv)
    roots = [r.split("=", 1) for r in args.roots]
    work = args.workdir or tempfile.mkdtemp(prefix="bench_queues.")
    os.makedirs(work, exist_ok=True)
    if args.warmup_splats:
        path, spacing = write_cloud(args.warmup_splats, work)
        for label, root in dict(roots).items():
            res = run_cli(os.path.abspath(root), path, spacing,
                          ["--device", args.device[0]])
            print(f"WARMUP {label} {res['wall_s']:.3f} s", flush=True)
        os.remove(path)
    runs = []
    for i, n in enumerate(args.splats):
        path, spacing = write_cloud(n, work)
        for dev in args.device:
            for q in (args.queues if i == 0 else args.big_queues):
                for label, root in roots:
                    res = run_cli(os.path.abspath(root), path, spacing,
                                  ["--device", dev, "--device-threads",
                                   str(q)])
                    res.update(root=label, splats=n, device=dev, queues=q)
                    print("RUN " + json.dumps(res), flush=True)
                    runs.append(res)
        if i == 0 and args.profile:
            profile_runs(args, [r.split("=", 1) for r in args.profile_roots]
                         if args.profile_roots else roots, n, path, spacing)
        os.remove(path)
    ratios = {}
    for r in runs:
        ref = [o for o in runs if o["root"] == r["root"]
               and o["splats"] == r["splats"] and o["queues"] == 1
               and o["device"] == args.device[0]]
        key = f"{r['root']} {r['splats']} {r['device']} {r['queues']}"
        ratios.setdefault(key, []).append(
            r["wall_s"] / (sum(o["wall_s"] for o in ref) / len(ref))
            if ref else None)
    digests = {}
    for r in runs:
        digests.setdefault(r["splats"], set()).add(r["digest"])
    print("SUMMARY " + json.dumps({
        "wall_ratio_to_1_queue": ratios,
        "one_digest_per_cloud": all(len(d) == 1 for d in digests.values()),
        "left_running": sum(len(r["left_running"]) for r in runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
