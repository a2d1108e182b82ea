"""Command line: `python -m mlsgpu_tpu_torch -o out.ply in1.ply in2.ply`.

The option surface is the JAX package's (`mlsgpu_tpu/cli.py:23-178`,
copied here with the same options and defaults), plus `--device` (default
cuda). `--readback codes|packed|raw|auto` picks the block readback (`auto`:
packed on a card, which welds on the device; codes on the CPU, rebuilt
and welded by the native host library, or packed without it) and
`--statistics-device` times each block-step stage on the device
(`device.<stage>.time`). A multi-host run starts one process per rank with
`--coordinator HOST:PORT --num-processes N --process-id R` (parallel/
multihost.py: torch.distributed over gloo, rank 0 hosts the store).
`--device cuda` streams the blocks over every visible card, or the first
`--num-devices N`; `--device cuda:<i>` over that card alone; each card runs
`--device-threads T` queues (with more than one worker in all, a worker
process each, pipeline/workers.py), and any number of workers writes the
same bytes. A
rank of a multi-host run takes its cards as a single process does, so ranks
that share a machine each name their own (`--device cuda:<i>`, or
CUDA_VISIBLE_DEVICES). `--mls-backend` is a JAX-package choice and stops
with a clear error.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import List, Optional

from mlsgpu_tpu_torch import __version__
from mlsgpu_tpu_torch.config import ReconstructConfig, parse_capacity
from mlsgpu_tpu_torch.pipeline import worker_start
from mlsgpu_tpu_torch.utils import logging as log
from mlsgpu_tpu_torch.utils import misc, timeplot
from mlsgpu_tpu_torch.utils.errors import MlsError
from mlsgpu_tpu_torch.utils.statistics import get_registry


def build_parser() -> argparse.ArgumentParser:
    d = ReconstructConfig()
    p = argparse.ArgumentParser(
        prog="mlsgpu_tpu_torch",
        description="MLS surface reconstruction from point clouds "
                    "(PyTorch/CUDA port)",
        fromfile_prefix_chars="@")  # @file = the reference's --response-file
    p.add_argument("inputs", nargs="*", help="input PLY files")
    p.add_argument("-o", "--output-file", required=True, help="output PLY file")
    p.add_argument("--version", action="version",
                   version=f"mlsgpu_tpu_torch {__version__}")

    g = p.add_argument_group("fit options")
    g.add_argument("--fit-smooth", type=float, default=d.fit_smooth,
                   help="smoothing factor [%(default)s]")
    g.add_argument("--max-radius", type=float, default=None,
                   help="limit influence radii before smoothing")
    g.add_argument("--fit-grid", type=float, default=d.fit_grid,
                   help="spacing of output grid [%(default)s]")
    g.add_argument("--fit-prune", type=float, default=d.fit_prune,
                   help="prune components smaller than this fraction [%(default)s]")
    g.add_argument("--fit-boundary-limit", type=float, default=d.fit_boundary_limit,
                   help="larger values preserve more of the boundary [%(default)s]")
    g.add_argument("--fit-shape", choices=["sphere", "plane"], default=d.fit_shape)

    a = p.add_argument_group("advanced")
    a.add_argument("--levels", type=int, default=d.levels,
                   help="octree levels [%(default)s]")
    a.add_argument("--subsampling", type=int, default=d.subsampling,
                   help="octree subsampling shift [%(default)s]")
    a.add_argument("--leaf-cells", type=int, default=d.leaf_cells,
                   help="microblock size in cells [%(default)s]")
    a.add_argument("--device-block-shift", type=int,
                   default=d.device_block_shift,
                   help="largest device dispatch: 2^shift corners per axis; "
                        "bigger blocks stream as aligned sub-volumes "
                        "[%(default)s]")
    a.add_argument("--max-device-splats", type=parse_capacity,
                   default=d.max_device_splats,
                   help="splat budget per device block [%(default)s]")
    a.add_argument("--tile-candidates", type=parse_capacity, default=d.tile_candidates,
                   help="per-tile candidate cap (auto-grows) [%(default)s]")
    a.add_argument("--device-threads", type=int, default=d.device_threads,
                   help="queues per card; more than one worker in all "
                        "run as worker processes [%(default)s]")
    a.add_argument("--num-devices", type=int, default=0,
                   help="cards to use with --device cuda: the first N of "
                        "the visible ones, 0 = all; more than are visible "
                        "is an error [%(default)s]")
    a.add_argument("--split-size", type=parse_capacity, default=0,
                   help="approximate size of output chunks (0 = single file)")
    a.add_argument("--checkpoint", help="checkpoint state to PATH instead of writing")
    a.add_argument("--resume", help="resume from checkpoint PATH (write only)")
    a.add_argument("--tmp-dir", help="directory for temporary spill files")
    a.add_argument("--reader", choices=["syscall", "mmap", "stream"],
                   default="syscall",
                   help="input IO backend (reference --reader)")
    a.add_argument("--writer", choices=["syscall", "stream"],
                   default="syscall",
                   help="output IO backend (reference --writer)")
    a.add_argument("--mls-backend", choices=["auto", "xla", "pallas"],
                   default="auto", help="MLS kernel implementation")
    a.add_argument("--readback", choices=["auto", "codes", "packed", "raw"],
                   default="auto",
                   help="device->host mesh readback format: codes = per-"
                        "cell case codes + interpolants, host rebuilds the "
                        "welded mesh natively; packed = quantized mesh "
                        "welded on the device; raw = full arrays; auto = "
                        "packed on a CUDA device, codes on the CPU (packed "
                        "without the native library) [auto]")
    a.add_argument("--mem-reorder", type=parse_capacity, default=d.mem_reorder,
                   help="mesher reorder-window byte budget before spilling "
                        "to disk [%(default)s]")
    a.add_argument("--mem-load-splats", type=parse_capacity,
                   default=d.mem_load_splats,
                   help="loader queue byte budget [%(default)s]")
    a.add_argument("--mem-host-splats", type=parse_capacity,
                   default=d.mem_host_splats,
                   help="bytes of splats resident on the host (queue + "
                        "in-flight) [%(default)s]")
    a.add_argument("--mem-bucket-splats", type=parse_capacity,
                   default=d.mem_bucket_splats,
                   help="splat byte budget per bucket [%(default)s]")
    a.add_argument("--mem-mesh", type=parse_capacity, default=d.mem_mesh,
                   help="in-flight mesh readback byte budget [%(default)s]")
    a.add_argument("--mem-blobs", type=parse_capacity, default=d.mem_blobs,
                   help="blob records kept in RAM before spilling to the "
                        "disk-resident blob store [%(default)s]")
    a.add_argument("--max-split", type=parse_capacity, default=d.max_split,
                   help="max subdivisions per bucketing pass [%(default)s]")
    a.add_argument("--decache", action="store_true",
                   help="evict inputs from the page cache first (cold-cache runs)")

    m = p.add_argument_group(
        "distributed (the reference's mlsgpu-mpi interface, mlsgpu-mpi.cpp)")
    m.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="coordinator address of a multi-host run (process 0)")
    m.add_argument("--num-processes", type=int, default=1,
                   help="total processes in the multi-host run [%(default)s]")
    m.add_argument("--process-id", type=int, default=0,
                   help="this process's rank [%(default)s]")
    m.add_argument("--scatter", choices=("dynamic", "static"),
                   default=d.scatter,
                   help="work distribution: dynamic = chunks claimed from a "
                        "shared queue (pull-model, self-balancing), static = "
                        "one-shot greedy assignment [%(default)s]")

    o = p.add_argument_group("observability")
    o.add_argument("--statistics", action="store_true",
                   help="print statistics at exit")
    o.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the run into DIR "
                        "(DIR/trace.json, Chrome trace format; the "
                        "reference's --statistics-cl event timing analogue). "
                        "To trace the block steps of each device worker, "
                        "worker processes included, set the environment "
                        "variable MLSGPU_PROFILE_STEPS=DIR instead: each "
                        "worker writes a trace of its steps 3-6 and their "
                        "split into dispatch, sync wait and card busy time "
                        "to DIR/<worker>.<pid>.json (utils/step_profile.py). "
                        "With --timeplot FILE too, the run first launches a "
                        "short spin kernel on the card at the "
                        "time.monotonic() it writes to DIR/anchor.json, so "
                        "that the trace and the timeplot's spans can be put "
                        "on one clock")
    o.add_argument("--statistics-file", help="write statistics to file")
    o.add_argument("--statistics-device", action="store_true",
                   help="time each device stage (binning/MLS/marching/weld) "
                        "into the statistics registry; fences the pipeline, "
                        "so profiling only (the reference's --statistics-cl, "
                        "src/statistics_cl.h:43-93); with several queues a "
                        "stage's time includes its wait for the card while "
                        "other queues use it")
    o.add_argument("--timeplot", help="write timing trace to file")
    o.add_argument("--quiet", action="store_true")
    o.add_argument("--debug", action="store_true")
    o.add_argument("--no-progress", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the hand-written kernel; every "
                        "visible card, see --num-devices), cuda:<i> (that "
                        "card alone) or cpu (the plain PyTorch path) "
                        "[%(default)s]")
    return p


def config_from_args(args) -> ReconstructConfig:
    return ReconstructConfig(
        fit_smooth=args.fit_smooth,
        fit_grid=args.fit_grid,
        fit_prune=args.fit_prune,
        fit_boundary_limit=args.fit_boundary_limit,
        fit_shape=args.fit_shape,
        max_radius=args.max_radius if args.max_radius is not None else float("inf"),
        levels=args.levels,
        subsampling=args.subsampling,
        leaf_cells=args.leaf_cells,
        device_block_shift=args.device_block_shift,
        max_device_splats=args.max_device_splats,
        tile_candidates=args.tile_candidates,
        device_threads=args.device_threads,
        num_devices=args.num_devices,
        scatter=args.scatter,
        output_split_size=args.split_size,
        mls_backend=args.mls_backend,
        readback=args.readback,
        mem_reorder=args.mem_reorder,
        mem_load_splats=args.mem_load_splats,
        mem_host_splats=args.mem_host_splats,
        mem_bucket_splats=args.mem_bucket_splats,
        mem_mesh=args.mem_mesh,
        mem_blobs=args.mem_blobs,
        max_split=args.max_split,
        decache=args.decache,
        checkpoint=args.checkpoint,
        resume=args.resume,
        tmp_dir=args.tmp_dir,
        timeplot=args.timeplot,
        statistics=args.statistics,
        statistics_file=args.statistics_file,
        statistics_device=args.statistics_device,
        progress=not args.no_progress,
    )


def distributed_problem(args) -> Optional[str]:
    """What is wrong with the multi-host options, or None."""
    if args.num_processes < 1:
        return "--num-processes must be at least 1"
    if args.num_processes > 1 and not args.coordinator:
        return "--num-processes > 1 needs --coordinator HOST:PORT"
    if not 0 <= args.process_id < args.num_processes:
        return (f"--process-id {args.process_id} outside "
                f"0..{args.num_processes - 1}")
    return None


def _anchor(trace_dir: str, device) -> None:
    """Launch torch's spin kernel (`spin_kernel`, a microsecond) on the idle
    card `device` and write the time.monotonic() of its launch to
    DIR/anchor.json: the kernel's start in the trace is that time on the
    timeplot's clock."""
    import torch
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        launched = time.monotonic()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    with open(os.path.join(trace_dir, "anchor.json"), "w") as f:
        json.dump({"kernel": "spin_kernel", "device": str(device),
                   "monotonic": launched}, f)


@contextlib.contextmanager
def _profile(trace_dir: Optional[str], devices, anchor: bool = False):
    """--profile: a torch.profiler trace of the run, written as a Chrome
    trace into the directory; with `anchor` (--timeplot given too) it
    starts with _anchor on the first card."""
    if not trace_dir:
        yield
        return
    import torch.profiler as tp
    acts = [tp.ProfilerActivity.CPU]
    cards = [d for d in devices if d.type == "cuda"]
    if cards:
        acts.append(tp.ProfilerActivity.CUDA)
    with tp.profile(activities=acts) as prof:
        if anchor and cards:
            _anchor(trace_dir, cards[0])
        yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info(f"device profile written to {path}")


def _leave_failed_job(code: int) -> None:
    """End this rank of a distributed run without the interpreter's
    shutdown, which could wait on a process group whose peers are gone."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def main(argv: Optional[List[str]] = None) -> int:
    entered = time.monotonic()
    args = build_parser().parse_args(argv)
    if args.quiet:
        log.set_log_level("quiet")
    elif args.debug:
        log.set_log_level("debug")
    cfg = config_from_args(args)
    server = not args.resume and worker_start.several_workers(cfg,
                                                              args.device)
    if server:
        # worker processes fork from a server that imports torch and the
        # block step's modules beside this process's own imports (next)
        try:
            worker_start.hold_server()
        except MlsError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    try:
        return _run(args, cfg, entered)
    finally:
        if server:
            worker_start.release_server()


def _run(args, cfg: ReconstructConfig, entered: float) -> int:
    """main() after the options are parsed and the worker server, if the
    run needs one, is held; `entered` is when main() was."""
    from mlsgpu_tpu_torch.pipeline.reconstruct import (check_supported,
                                                       reconstruct, resume)
    try:
        cfg.validate()
        check_supported(cfg)
    except MlsError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    problem = distributed_problem(args)
    if not problem and not args.resume and not args.inputs:
        problem = "no input files"
    if problem:
        print(f"error: {problem}", file=sys.stderr)
        return 2
    if cfg.tmp_dir:
        misc.set_tmp_dir(cfg.tmp_dir)
    if cfg.timeplot:
        timeplot.init(cfg.timeplot)

    from mlsgpu_tpu_torch.io.splat_set import FileSource
    from mlsgpu_tpu_torch.utils import provenance
    from mlsgpu_tpu_torch.utils.diskstats import DiskUsage

    start = time.monotonic()
    stats = get_registry()
    # what main() took before the run: its imports (torch among them)
    stats.variable("cli.importTime").add(start - entered)
    transport = None
    try:
        if not args.resume:
            # before any rank connects: a bad device option ends the run here
            from mlsgpu_tpu_torch.device import resolve_devices
            devices = resolve_devices(args.device, cfg.num_devices)
        if args.num_processes > 1:
            # MPI_Init analogue (mlsgpu-mpi.cpp:513)
            from mlsgpu_tpu_torch.parallel import multihost
            transport = multihost.init_distributed(
                args.coordinator, args.num_processes, args.process_id)
        if args.resume:
            if transport is not None:
                outputs = multihost.resume_distributed(
                    args.resume, cfg, args.output_file, transport)
            else:
                outputs = resume(args.resume, cfg, args.output_file)
        else:
            from mlsgpu_tpu_torch.io.binary import make_writer
            from mlsgpu_tpu_torch.io.ply import PlyWriter
            if cfg.decache:
                from mlsgpu_tpu_torch.io.decache import decache_all
                decache_all(args.inputs)
            comments = provenance.comments()

            def writer_factory():
                return PlyWriter(writer=make_writer(args.writer),
                                 comments=comments)

            source = FileSource(args.inputs, smooth=cfg.fit_smooth,
                                max_radius=cfg.max_radius,
                                reader_type=args.reader)
            try:
                with DiskUsage(), _profile(args.profile, devices,
                                           anchor=bool(cfg.timeplot)):
                    if transport is not None:
                        outputs = multihost.reconstruct_distributed(
                            source, cfg, args.output_file, transport,
                            device=devices, writer_factory=writer_factory)
                    else:
                        outputs = reconstruct(source, cfg, args.output_file,
                                              device=devices,
                                              writer_factory=writer_factory)
            finally:
                source.close()
        if transport is not None:
            transport.close()
    except (MlsError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        if transport is not None:
            _leave_failed_job(1)
        return 1
    except BaseException:
        if transport is None:
            raise
        # A rank that fails must leave at once with a failing code: its
        # peers notice (a closed socket, a stale heartbeat) and abort too
        # (reference MPI error handler semantics, mlsgpu-mpi.cpp:541-628).
        import traceback
        traceback.print_exc()
        _leave_failed_job(1)

    elapsed = time.monotonic() - start
    stats.variable("run.time").add(elapsed)
    if cfg.checkpoint:
        log.info(f"checkpoint written in {elapsed:.1f}s")
    else:
        log.info(f"reconstructed {len(outputs)} file(s) in {elapsed:.1f}s")
    if cfg.statistics or cfg.statistics_file:
        if cfg.statistics_file:
            with open(cfg.statistics_file, "w") as out:
                stats.dump(out)
        else:
            stats.dump(sys.stdout)
    timeplot.init(None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
