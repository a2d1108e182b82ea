"""One run of one cell: set-up, the measured window, the reference's
verdict, and the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1> [--rehearse]

Set-up (timed as `setup_s`, from the start of the process): the caches'
directories inside the checkout, torch and the program's imports, the
cloud made from the seed and written as a PLY under TMPDIR, and one whole
warm-up job. A cell's workers are threads of the run's process: the
harness refuses a cell whose options start worker processes, since it
reads the card's memory and trace from its own process.

The window runs whole jobs back to back: a job is one call of the
program's `reconstruct` on the whole cloud, with the configuration the
program's own command line parses from the cell's options, the cell's
cards, and the program's PLY writer over a memory sink of the benchmark's.
A job starts only while the deadline has not passed; the window ends when
the last job ends. With `--trace 1` the first job of the window runs
under the profiler (again on the next one if the trace lost kernel
events), and the per-layer metrics are read; with `--trace 0` the
end-to-end ones.

Once the window has closed and the program's state is freed, the plain
reference (portbench/reference.py) judges the mesh of one job drawn from
the seed, and the last job's bytes are compared with it. The last lines on
standard error and the result's last key give each number compared beside
its limit. The check that no module of JAX or the JAX package is loaded
comes after the verdict, just before the result is printed.

`--rehearse` runs the cell on the CPU at the configuration's rehearsal
size, with the program's plain versions of its kernels, and prints no
metric: a rehearsal measures nothing. A measuring run that finds no card,
or fewer than the cell asks for, exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

from portbench import catalog
from portbench.context import MetricContext

ROOT = os.path.dirname(catalog.HERE)
#: Top-level module names that may not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "mlsgpu_tpu", "bench")
#: Caches of the program, at fixed paths inside the checkout.
CACHE = os.path.join(ROOT, ".portbench_cache")
CACHE_ENV = {"MLSGPU_TORCH_BUILD_DIR": os.path.join(CACHE, "build"),
             "TORCH_EXTENSIONS_DIR": os.path.join(CACHE, "torch_extensions"),
             "TRITON_CACHE_DIR": os.path.join(CACHE, "triton")}


class NoCard(RuntimeError):
    """A measuring run without the cards the cell asks for."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="portbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="a run on the CPU at the rehearsal size: checks the "
                        "path and the verdict, measures nothing")
    return p.parse_args(argv)


def cell_config(cell: catalog.Cell, rehearse: bool) -> Dict:
    """The cell's configuration, with its rehearsal block laid over it for
    a rehearsal (a smaller cloud, fewer levels, the CPU)."""
    cfg = dict(cell.config, cloud=dict(cell.config["cloud"]))
    if rehearse:
        cfg.update({k: v for k, v in cfg["rehearsal"].items()
                    if k != "splats"})
        cfg["cloud"]["splats"] = cfg["rehearsal"]["splats"]
    return cfg


def option_list(cfg: Dict, traffic: Dict, fit_grid: float) -> List[str]:
    opts = ["--fit-grid", repr(fit_grid)]
    for key in ("fit_smooth", "fit_prune", "fit_boundary_limit", "fit_shape",
                "levels", "subsampling", "max_device_splats",
                "tile_candidates", "device_threads", "num_devices", "device"):
        opts += ["--" + key.replace("_", "-"), str(cfg[key])]
    return opts + ["--readback", traffic["readback"], "--no-progress"]


class Session:
    """A cell's program, set up for jobs: the cloud made from the seed and
    written as a PLY under a work directory of TMPDIR, the configuration
    the program's command line parses from the cell's options, and the
    cards. Use as a context manager; `job(sink)` runs one whole
    reconstruction."""

    def __init__(self, cell: catalog.Cell, seed: int, rehearse: bool):
        self.cell, self.seed, self.rehearse = cell, seed, rehearse
        self.cfg = cell_config(cell, rehearse)
        self.workdir: Optional[str] = None

    def __enter__(self) -> "Session":
        from mlsgpu_tpu_torch import cli
        from mlsgpu_tpu_torch.pipeline import worker_start
        from mlsgpu_tpu_torch.utils import logging as log
        from portbench.traffic.generator import write_splats_ply

        log.set_log_level("quiet")
        self.workdir = tempfile.mkdtemp(prefix="portbench-")
        splats, sr = self.cloud_and_radius()
        self.splats = len(splats)
        self.fit_grid = float(sr / self.cfg["cloud"]["splat_radius_per_cell"])
        self.ply = os.path.join(self.workdir, "cloud.ply")
        write_splats_ply(self.ply, splats)
        del splats
        opts = option_list(self.cfg, self.cell.traffic, self.fit_grid)
        self.args = cli.build_parser().parse_args(
            opts + ["-o", "mesh.ply", self.ply])
        self.config = cli.config_from_args(self.args)
        if worker_start.several_workers(self.config, self.args.device):
            raise ValueError(
                f"the cell {self.cell.name} starts worker processes, whose "
                "card memory and trace this harness does not read")
        from mlsgpu_tpu_torch.device import resolve_devices
        self.devices = resolve_devices(self.args.device,
                                       self.config.num_devices)
        self.on_card = self.devices[0].type == "cuda"
        return self

    def __exit__(self, *exc) -> None:
        if self.workdir is not None:
            shutil.rmtree(self.workdir, ignore_errors=True)
            self.workdir = None

    def cloud_and_radius(self):
        """The cell's cloud made from the seed, and its splat radius."""
        from portbench.traffic.generator import make_cloud
        c = self.cfg["cloud"]
        return make_cloud(c["splats"], self.seed, self.cell.traffic["order"],
                          c["sphere_radius"], c["spacings_per_radius"])

    def job(self, sink) -> None:
        """One whole reconstruction of the cloud into `sink`: the path the
        program's command line runs, through its own PLY writer."""
        from mlsgpu_tpu_torch.io.ply import PlyWriter
        from mlsgpu_tpu_torch.io.splat_set import FileSource
        from mlsgpu_tpu_torch.pipeline import reconstruct as rec_mod
        source = FileSource([self.ply], smooth=self.config.fit_smooth,
                            max_radius=self.config.max_radius,
                            reader_type=self.args.reader)
        try:
            rec_mod.reconstruct(source, self.config, "mesh.ply",
                                device=self.devices,
                                writer_factory=lambda: PlyWriter(writer=sink),
                                show_progress=False)
        finally:
            source.close()

    def judge(self, sink, control=None) -> Dict:
        """The reference's readings of the mesh in `sink`, with the cloud
        made again from the seed (the program's state freed first). With
        `control` (a lower precision), also `control_gap_cells`."""
        import torch
        from portbench import reference
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()
        cloud, _ = self.cloud_and_radius()
        cfg, spec = self.cfg, self.cell.spec
        return reference.judge(
            sink.contents(), cloud, self.fit_grid, float(cfg["fit_smooth"]),
            float(cfg["fit_prune"]),
            1.0 - float(cfg["fit_boundary_limit"]) ** 2, self.seed,
            spec["sample"], int(spec["seam_plane_cells"]),
            self.devices[0] if self.on_card else torch.device("cpu"),
            control=control)


def check_card(cell: catalog.Cell) -> None:
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        raise NoCard(f"the cell {cell.name} needs {cell.chips} CUDA "
                     f"card(s); this machine has {have}")


def set_environment() -> None:
    for k, v in CACHE_ENV.items():
        os.environ[k] = v


def run(argv=None, start: Optional[float] = None, faults=(),
        control: bool = False) -> int:
    """The whole run; returns the exit code. `start` is the process's
    start on the monotonic clock. For the benchmark's own checks:
    `faults` names faults of portbench/faults.py to plant in the program
    before the warm-up job, and `control` puts the control in the
    program's place for the verdict (the reference in bfloat16: each
    judged vertex where that field crosses zero along its edge)."""
    start = time.monotonic() if start is None else start
    args = parse_args(argv)
    set_environment()
    cell = catalog.load_cell(catalog.benchmark(ROOT), args.workload)
    if not args.rehearse:
        check_card(cell)
    with Session(cell, args.seed, args.rehearse) as session:
        if faults:
            from portbench import faults as planted
            for name in faults:
                planted.plant(name)
        return measure(args, session, start, control)


def measure(args, session: Session, start: float, control: bool = False
            ) -> int:
    import torch
    from mlsgpu_tpu_torch.ops import launches
    from mlsgpu_tpu_torch.utils.statistics import get_registry
    from portbench import memory, roofline, trace
    from portbench.sink import MemorySink

    cell, devices, on_card = session.cell, session.devices, session.on_card
    sinks = [MemorySink(), MemorySink()]
    session.job(sinks[1])                       # the warm-up job
    for s in sinks:
        s.reserve(sinks[1].size)
    judged = int(np.random.default_rng([args.seed, 1]).integers(
        cell.spec["judge_within"]))
    stats = get_registry()
    stats.clear()
    if on_card:
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    rss = memory.RssSampler()
    rss.start()
    attempted = failed = 0
    summary = None
    traced_launches: Dict[str, int] = {}
    lost_note = []
    job_s: List[float] = []
    job_cpu_s: List[List[float]] = []     # user, system seconds a job
    error = None
    t_lo = time.monotonic()
    deadline = t_lo + args.seconds
    setup_s = t_lo - start
    while time.monotonic() < deadline:
        sink = sinks[0] if attempted == judged else sinks[1]
        attempted += 1
        t_job, cpu_job = time.monotonic(), os.times()
        try:
            if args.trace and on_card and summary is None:
                got, counted = trace.traced_job(
                    lambda: session.job(sink), session.workdir,
                    f"job{attempted}", launches.counts)
                lost = trace.lost_launches(got, counted)
                if lost:
                    lost_note.append({"lost": lost, "traced": sorted(
                        got.kernels.items(), key=lambda kv: -kv[1])[:12]})
                else:
                    summary, traced_launches = got, counted
            else:
                session.job(sink)
            job_s.append(time.monotonic() - t_job)
            cpu = os.times()
            job_cpu_s.append([cpu.user - cpu_job.user,
                              cpu.system - cpu_job.system])
        except Exception:
            failed += 1
            error = traceback.format_exc()
            break
    t_hi = time.monotonic()
    window_s = t_hi - t_lo
    peak_rss = rss.stop()
    window_stats = stats.to_dict()
    mem_peak = (max(torch.cuda.max_memory_allocated(d) for d in devices)
                if on_card else 0)
    if error is not None:
        print(error, file=sys.stderr)
    if args.trace and on_card and not failed and summary is None:
        print(f"error: no traced job could be read: {lost_note}",
              file=sys.stderr)
        return 4

    # the verdict, once the window has closed
    judge_idx = judged if attempted > judged else attempted - 1
    judged_sink = sinks[0] if judge_idx == judged else sinks[1]
    last_sink = sinks[0] if attempted - 1 == judged else sinks[1]
    t_ref = time.monotonic()
    readings = session.judge(
        judged_sink, control=torch.bfloat16 if control else None)
    if control:
        readings["vertex_gap_cells"] = readings["control_gap_cells"]
    readings["jobs_differing"] = int(
        last_sink is not judged_sink and attempted - failed > 1
        and not np.array_equal(last_sink.contents(), judged_sink.contents()))
    reference_s = time.monotonic() - t_ref
    limits = cell.spec["rehearsal_limits" if args.rehearse else "limits"]
    checks = {k: {"value": readings[k], "limit": v} for k, v in limits.items()}
    correct = (failed == 0 and attempted > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    ctx = MetricContext(
        jobs=attempted - failed, splats=session.splats, window_s=window_s, setup_s=setup_s,
        peak_rss_bytes=peak_rss, sink_bytes=sum(s.nbytes for s in sinks),
        field_bytes=roofline.dense_field_bytes(1 << session.config.device_shift),
        stats=window_stats, trace=summary, traced_launches=traced_launches)
    if args.rehearse:
        metrics = {}
    else:
        metrics = catalog.read_metrics(
            cell.per_layer if args.trace else cell.end_to_end, ctx)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics}
    if args.rehearse:
        result["device"] = {"platform": "cpu", "kind": "rehearsal",
                            "count": 0, "memory_peak_bytes": 0}
        result["rehearsal"] = True
    else:
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(devices[0]),
                            "count": cell.chips,
                            "memory_peak_bytes": int(mem_peak)}
        if args.trace:
            result["device"].update(busy_s=summary.busy_s,
                                    window_s=summary.wall_s)
            result["breakdown"] = breakdown(summary)
    cloud, _ = session.cloud_and_radius()
    info = {"jobs": attempted - failed, "judged_job": judge_idx,
            "splats": session.splats, "window_s": window_s,
            "setup_s": setup_s, "reference_s": reference_s,
            "job_s": job_s, "job_cpu_s": job_cpu_s,
            "mcells_per_s": (grid_cells(cloud, session.fit_grid) * ctx.jobs
                             / window_s / 1e6 if window_s > 0 else None),
            "vertices": readings["vertices"],
            "triangles": readings["triangles"],
            "components": readings["components"],
            "corner_duplicates": readings["corner_duplicates"],
            "judged_vertices": readings["judged_vertices"],
            "mesh_bytes": int(judged_sink.size),
            "mesh_sha1": hashlib.sha1(judged_sink.contents()).hexdigest(),
            "peak_rss_bytes": peak_rss, "sink_bytes": ctx.sink_bytes,
            "lost_trace_events": lost_note}
    print("INFO " + json.dumps(info))
    found = forbidden_modules()
    if found:
        print(f"error: loaded {found}: JAX or the JAX package",
              file=sys.stderr)
        return 3
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def grid_cells(cloud: np.ndarray, spacing: float) -> int:
    """Cells of the grid a reconstruction of `cloud` spans: every cell a
    splat's bounding box touches, per axis from the least to the most
    (upstream mlsgpu's grid); with Msplats/s, the BASELINE.json pair."""
    inv = np.float32(1.0) / np.float32(spacing)
    pos, r = cloud[:, 0:3], cloud[:, 3:4]
    lo = np.floor((pos - r) * inv).min(axis=0)
    hi = np.floor((pos + r) * inv).max(axis=0)
    return int(np.prod(hi - lo + 1))


def breakdown(summary) -> Dict:
    ops = sorted(summary.kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in summary.idle_gaps[:10]]}


def main(argv=None, start: Optional[float] = None) -> int:
    try:
        return run(argv, start)
    except NoCard as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
