"""Command line: `python -m mlsgpu_tpu_torch -o out.ply in1.ply in2.ply`.

The option surface is the JAX package's (`mlsgpu_tpu.cli.build_parser`),
plus `--device` (default cuda). `--readback codes|packed|raw|auto` picks the
block readback and `--statistics-device` times each block-step stage on the
device (`device.<stage>.time`). Options whose code paths are not ported yet
stop with a clear error: multi-host (`--coordinator`, `--num-processes`) and
multi-GPU (`--num-devices > 1`); `--mls-backend` is a JAX-package choice.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import List, Optional

from mlsgpu_tpu.cli import build_parser as _jax_build_parser
from mlsgpu_tpu.cli import config_from_args
from mlsgpu_tpu.utils import logging as log
from mlsgpu_tpu.utils import misc, timeplot
from mlsgpu_tpu.utils.errors import MlsError
from mlsgpu_tpu.utils.statistics import get_registry


def build_parser():
    p = _jax_build_parser()
    p.prog = "mlsgpu_tpu_torch"
    p.description = ("MLS surface reconstruction from point clouds "
                     "(PyTorch/CUDA port)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the hand-written kernel) or "
                        "cpu (the plain PyTorch path) [%(default)s]")
    return p


def unported_options(args) -> Optional[str]:
    """The CLI-only options that are still unported (multi-host); the
    configuration's own (--num-devices > 1) are refused by
    pipeline.reconstruct.check_supported."""
    if args.coordinator or args.num_processes > 1:
        return "--coordinator/--num-processes: multi-host not yet ported"
    return None


@contextlib.contextmanager
def _profile(trace_dir: Optional[str], device):
    """--profile: a torch.profiler trace of the run, written as a Chrome
    trace into the directory."""
    if not trace_dir:
        yield
        return
    import torch.profiler as tp
    acts = [tp.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(tp.ProfilerActivity.CUDA)
    with tp.profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info(f"device profile written to {path}")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.quiet:
        log.set_log_level("quiet")
    elif args.debug:
        log.set_log_level("debug")
    cfg = config_from_args(args)
    from mlsgpu_tpu_torch.pipeline.reconstruct import (check_supported,
                                                       reconstruct, resume)
    try:
        cfg.validate()
        check_supported(cfg)
    except MlsError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    problem = unported_options(args)
    if problem:
        print(f"error: {problem}", file=sys.stderr)
        return 2
    if cfg.tmp_dir:
        misc.set_tmp_dir(cfg.tmp_dir)
    if cfg.timeplot:
        timeplot.init(cfg.timeplot)

    from mlsgpu_tpu.io.splat_set import FileSource
    from mlsgpu_tpu.utils import provenance
    from mlsgpu_tpu.utils.diskstats import DiskUsage

    start = time.monotonic()
    stats = get_registry()
    try:
        if args.resume:
            outputs = resume(args.resume, cfg, args.output_file)
        else:
            if not args.inputs:
                print("error: no input files", file=sys.stderr)
                return 2
            from mlsgpu_tpu.io.binary import make_writer
            from mlsgpu_tpu.io.ply import PlyWriter
            from mlsgpu_tpu_torch.device import resolve_device
            device = resolve_device(args.device)
            if cfg.decache:
                from mlsgpu_tpu.io.decache import decache_all
                decache_all(args.inputs)
            comments = provenance.comments()

            def writer_factory():
                return PlyWriter(writer=make_writer(args.writer),
                                 comments=comments)

            source = FileSource(args.inputs, smooth=cfg.fit_smooth,
                                max_radius=cfg.max_radius,
                                reader_type=args.reader)
            try:
                with DiskUsage(), _profile(args.profile, device):
                    outputs = reconstruct(source, cfg, args.output_file,
                                          device=device,
                                          writer_factory=writer_factory)
            finally:
                source.close()
    except (MlsError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

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
