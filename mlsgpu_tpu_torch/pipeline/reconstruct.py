"""End-to-end reconstruction driver: splat source -> manifold mesh PLY
(port of mlsgpu_tpu/pipeline/reconstruct.py).

blob pass -> bucketing -> per-bucket device block step (streamer) -> host
decode of each block's readback (codes: native rebuild + weld; packed:
native unpack; raw: the welded arrays) on the streamer's decode stage, a
thread per worker -> optional host filters and the mesher's order-free
prepare on a small pool -> the out-of-core mesher's commit, on a thread of
its own, in the loader's order -> write. The host layer (blobs,
bucketing, mesher, native helpers, host mesh filters) is the port's copy
of the JAX package's (pipeline/blobs.py, bucket.py, mesher.py,
mesh_filter.py, _native/).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import numpy as np

from mlsgpu_tpu_torch import _native
from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.io.splat_set import SplatSource
from mlsgpu_tpu_torch.pipeline import blobs as blobs_mod
from mlsgpu_tpu_torch.pipeline.mesher import BlockInput, OOCMesher
from mlsgpu_tpu_torch.utils import logging as log
from mlsgpu_tpu_torch.utils import misc, timeplot
from mlsgpu_tpu_torch.utils.errors import InvalidOption, MlsError
from mlsgpu_tpu_torch.utils.progress import NullProgress, ProgressDisplay
from mlsgpu_tpu_torch.utils.statistics import get_registry

from mlsgpu_tpu_torch.device import resolve_device, resolve_devices
from mlsgpu_tpu_torch.ops.block import resolve_readback, unpack_readback_global
from mlsgpu_tpu_torch.pipeline import bucket as bucket_mod
from mlsgpu_tpu_torch.pipeline.resources import validate_device
from mlsgpu_tpu_torch.pipeline.streamer import (HostBlock, consume_threaded,
                                                start_stream_workers,
                                                stream_blocks)
from mlsgpu_tpu_torch.pipeline.workers import stop_workers


def check_supported(cfg: ReconstructConfig) -> None:
    """Options of the JAX package that mean nothing here stop the run; they
    never quietly take another path."""
    if cfg.mls_backend != "auto":
        raise InvalidOption(f"--mls-backend {cfg.mls_backend}: a JAX-package "
                            "option; the port always uses its CUDA kernel "
                            "on the card")


def require_native():
    """The native host library (built with g++ on first use). The codes
    readback needs its block rebuild: its absence is an error (--readback
    auto resolves to packed without it)."""
    lib = _native.get_lib()
    if lib is None:
        why = (f"{_native.DISABLE_ENV} is set"
               if os.environ.get(_native.DISABLE_ENV)
               else _native.last_error or "unknown error")
        raise MlsError(f"native host library unavailable ({why}); it "
                       f"builds with g++ into {_native.library_path()}")
    return lib


def prepare_run(cfg: ReconstructConfig, device, device_filter=None):
    """What every run settles before its first pass, single-process or one
    rank of a distributed run: the options are valid and ported, the
    devices exist, the readback mode is resolved from the devices' type
    (here and nowhere else; ops/block.py::resolve_readback),
    the native library is there when that mode needs it, and the device
    memory estimate fits every card once per queue
    (resources.validate_device). `device` is a name or a torch device,
    resolved with --num-devices (device.resolve_devices), or a sequence of
    devices taken as it is (it may repeat one). Returns (list of torch
    devices, readback mode)."""
    cfg.validate()
    check_supported(cfg)
    if isinstance(device, (list, tuple)):
        devices = [resolve_device(str(d)) for d in device]
        if not devices:
            raise InvalidOption("no device to run on")
    else:
        devices = resolve_devices(str(device), cfg.num_devices)
    # A device filter needs the raw arrays (its vertices leave the lattice
    # the other layouts encode).
    if device_filter is not None:
        readback = "raw"
    else:
        readback = resolve_readback(cfg.readback, cfg.device_levels,
                                    cfg.subsampling, devices[0].type)
    log.info(f"readback mode: {readback}"
             + (" (a device filter needs raw arrays)"
                if device_filter is not None else ""))
    if readback == "codes":
        require_native()
    validate_device(cfg, devices, readback, cfg.device_threads)
    misc.bound_mmap_threshold()  # keep cycling per-block buffers off brk
    return devices, readback


def output_chunk_cells(cfg: ReconstructConfig) -> Optional[int]:
    """Cells per axis of one output chunk under --split-size (the
    reference's heuristic, src/mlsgpu_core.cpp:632-653), rounded up to
    whole blocks so chunks align with bucket boundaries; None for a single
    output file."""
    if not cfg.output_split_size:
        return None
    return misc.round_up(
        int(np.ceil(np.sqrt(cfg.output_split_size / 760.0))),
        cfg.device_block_cells)


def block_result_to_input(result: HostBlock, bucket) -> BlockInput:
    """One block's readback -> the mesher's BlockInput in global grid
    coordinates (mlsgpu_tpu/pipeline/reconstruct.py:240-309): codes are
    rebuilt and welded natively, a packed image is unpacked natively, raw
    arrays get the block origin added and their 63-bit weld keys joined.
    The block owns its triangles where the decode made them, and not
    where they are a view of the readback (raw; the numpy unpack's u32
    indices). A run calls it on the streamer's decode stage
    (stream_blocks(decode=)), whose `decode` action records its thread CPU
    time."""
    stats = get_registry()
    origin = bucket.cell_lo.astype(np.int64)
    with stats.timer("readback.decode"):
        if result.readback == "codes":
            verts, tris, keys, fe = _native.rebuild_block(
                result.packed, result.num_cells, result.num_unwelded,
                result.num_indices, result.fmt.nc_axis, origin,
                (bucket.cell_hi - bucket.cell_lo).astype(np.int64))
        elif result.readback == "packed":
            fe = result.first_external
            verts, tris, keys = unpack_readback_global(
                result.packed, result.num_indices, result.num_vertices, fe,
                result.fmt, origin)
        else:
            fe = result.first_external
            verts, hi, lo, tris = result.arrays
            verts = verts + origin.astype(np.float32)
            keys = (((hi.astype(np.int64) & 0x7FFFFFFF) << 32)
                    | lo.astype(np.int64))
    return BlockInput(chunk_id=bucket.chunk_id, vertices=verts,
                      first_external=fe, ext_keys=keys, triangles=tris,
                      owns_triangles=not any(np.may_share_memory(tris, a)
                                             for a in result.arrays))


@contextlib.contextmanager
def process_cpu(phase: str):
    """The process's CPU time over a phase of the run, every thread's
    (time.process_time), as `<phase>.cpu` seconds beside the phase's
    `<phase>.time`."""
    t0 = time.process_time()
    try:
        yield
    finally:
        get_registry().variable(f"{phase}.cpu").add(time.process_time()
                                                    - t0)


def reconstruct(source: SplatSource, cfg: ReconstructConfig, output: str,
                device="cuda", writer_factory=None,
                show_progress: Optional[bool] = None,
                mesher: Optional[OOCMesher] = None,
                filters=None, device_filter=None) -> List[str]:
    """Full single-process reconstruction over the devices of `device`
    (prepare_run: a name resolved with --num-devices, or a list). Returns
    the output files (none when cfg.checkpoint is set).

    filters: a host filter chain `(vertices, triangles) -> (vertices,
    triangles)` run on each block's decoded mesh in global grid coordinates
    (mesh_filter.MeshFilterChain). device_filter: a device vertex filter
    (mesh_filter.DeviceFilterChain) run inside the block step; it makes the
    readback raw (prepare_run resolves the mode once).

    The phases are actions of the timeplot worker `driver`: `blob_pass`,
    `bucketing` and `write` (its `write.passA`, `write.verts` and
    `write.tris` nested); pass 1 is the streamer's and the mesher's: its
    `prepare` actions on the pool's `mesher_prep` workers (the filters
    too), its commits as `mesher` actions (mesher.time, mesher.cpu)."""
    devices, readback = prepare_run(cfg, device, device_filter)
    stats = get_registry()
    driver = timeplot.Worker("driver")
    show_progress = cfg.progress if show_progress is None else show_progress
    # Worker processes (a run of more than one worker) start now, beside
    # the blob pass and bucketing; they stop with pass 1 or on any error.
    group = start_stream_workers(cfg, devices, readback, device_filter)
    try:
        with process_cpu("pass0"), timeplot.Action(
                "blob_pass", driver, stats.timer("pass0.time")):
            info = blobs_mod.compute_blobs(source, cfg.fit_grid,
                                           cfg.micro_cells,
                                           mem_budget=cfg.mem_blobs)

        chunk_cells = output_chunk_cells(cfg)
        max_splats = min(cfg.max_device_splats, cfg.mem_bucket_splats // 32)
        with process_cpu("bucket"), timeplot.Action("bucketing", driver):
            buckets = bucket_mod.make_buckets(
                info, cfg.device_block_cells, cfg.micro_cells,
                max_splats=max_splats, chunk_cells=chunk_cells,
                max_split=cfg.max_split)
            misc.malloc_trim()

        mesher = mesher or OOCMesher(info.grid, prune=cfg.fit_prune,
                                     reorder_budget=cfg.mem_reorder)
        if chunk_cells is not None:
            mesher.chunk_cells = chunk_cells
        if (cfg.output_split_size and not cfg.checkpoint
                and getattr(cfg, "eager_write", True)):
            expected: dict = {}
            for b in buckets:
                expected[b.chunk_id.coords] = \
                    expected.get(b.chunk_id.coords, 0) + 1
            mesher.enable_eager_write(output, expected,
                                      writer_factory=writer_factory)

        total = sum(b.num_splats for b in buckets)
        progress = (ProgressDisplay(total, label="reconstructing")
                    if show_progress else NullProgress())

        with stats.timer("pass1.time"), process_cpu("pass1"):
            mesher_worker = timeplot.Worker("mesher")

            def prepare(bucket, block):
                if filters is not None:
                    v, t = filters(block.vertices, block.triangles)
                    block = BlockInput(
                        chunk_id=block.chunk_id, vertices=v,
                        first_external=block.first_external,
                        ext_keys=block.ext_keys, triangles=t)
                return mesher.prepare(block)

            def consume(bucket, prepared):
                with timeplot.Action("mesher", mesher_worker,
                                     stats.variable("mesher.time"),
                                     stats.variable("mesher.cpu")):
                    mesher.commit(prepared)
                progress.add(bucket.num_splats)

            # a filter chain sees the blocks one at a time, in order
            consume_threaded(stream_blocks(source, info, buckets, cfg,
                                           devices, readback,
                                           device_filter=device_filter,
                                           group=group,
                                           decode=block_result_to_input),
                             consume, prepare=prepare,
                             threads=1 if filters is not None else 0)
    finally:
        stop_workers(group)

    if cfg.checkpoint:
        mesher.checkpoint(cfg.checkpoint)
        log.info(f"checkpointed mesher state to {cfg.checkpoint}")
        return []
    with process_cpu("write"), timeplot.Action("write", driver,
                                               stats.timer("write.time")):
        outputs = mesher.write(output, writer_factory=writer_factory,
                               split_size=cfg.output_split_size, plot=driver)
    mesher.cleanup()
    return outputs


def resume(checkpoint_path: str, cfg: ReconstructConfig, output: str,
           writer_factory=None) -> List[str]:
    """Write-only run from a checkpoint (--resume). The mesher is a copy of
    the JAX package's, so a checkpoint written by either resumes in both."""
    misc.bound_mmap_threshold()
    mesher = OOCMesher.resume(checkpoint_path)
    return mesher.write(output, writer_factory=writer_factory,
                        split_size=cfg.output_split_size)
