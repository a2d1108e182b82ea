"""End-to-end reconstruction driver: splat source -> manifold mesh PLY
(port of mlsgpu_tpu/pipeline/reconstruct.py).

blob pass -> bucketing -> per-bucket device block step (streamer) -> host
rebuild + weld of each block's codes image -> out-of-core mesher -> write.
The host layer (blobs, bucketing, mesher, native helpers) is the JAX
package's own, imported rather than copied; it never imports jax.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from mlsgpu_tpu import _native
from mlsgpu_tpu.config import ReconstructConfig
from mlsgpu_tpu.io.splat_set import SplatSource
from mlsgpu_tpu.pipeline import blobs as blobs_mod
from mlsgpu_tpu.pipeline import bucket as bucket_mod
from mlsgpu_tpu.pipeline.mesher import BlockInput, OOCMesher
from mlsgpu_tpu.utils import logging as log
from mlsgpu_tpu.utils import misc, timeplot
from mlsgpu_tpu.utils.errors import InvalidOption, MlsError
from mlsgpu_tpu.utils.progress import NullProgress, ProgressDisplay
from mlsgpu_tpu.utils.statistics import get_registry

from mlsgpu_tpu_torch.device import resolve_device
from mlsgpu_tpu_torch.pipeline.streamer import (HostCodes, consume_threaded,
                                                stream_blocks)


def check_supported(cfg: ReconstructConfig) -> None:
    """Options whose code paths are not ported yet stop the run; they never
    quietly take another path."""
    if cfg.readback not in ("auto", "codes"):
        raise InvalidOption(f"--readback {cfg.readback}: not yet ported "
                            "(the port reads back codes only)")
    if cfg.statistics_device:
        raise InvalidOption("--statistics-device: not yet ported")
    if cfg.num_devices > 1:
        raise InvalidOption("--num-devices > 1: multi-GPU not yet ported")
    if cfg.mls_backend != "auto":
        raise InvalidOption(f"--mls-backend {cfg.mls_backend}: a JAX-package "
                            "option; the port always uses its CUDA kernel "
                            "on the card")


def require_native():
    """The native host library (built with make on first use). The codes
    readback needs its block rebuild: its absence is an error."""
    lib = _native.get_lib()
    if lib is None:
        raise MlsError("native host library unavailable: build it with "
                       "`make -C mlsgpu_tpu/_native` (needs make and g++) "
                       "and unset MLSGPU_TPU_NO_NATIVE")
    return lib


def block_result_to_input(result: HostCodes, bucket) -> BlockInput:
    """Rebuild and weld one block's mesh natively from its codes image."""
    stats = get_registry()
    t_cpu = time.thread_time()
    with stats.timer("readback.decode"):
        verts, tris, keys, fe = _native.rebuild_block(
            result.packed, result.num_cells, result.num_unwelded,
            result.num_indices, result.fmt.nc_axis,
            bucket.cell_lo.astype(np.int64),
            (bucket.cell_hi - bucket.cell_lo).astype(np.int64))
    stats.variable("readback.decodeCpu").add(time.thread_time() - t_cpu)
    return BlockInput(chunk_id=bucket.chunk_id, vertices=verts,
                      first_external=fe, ext_keys=keys, triangles=tris)


def reconstruct(source: SplatSource, cfg: ReconstructConfig, output: str,
                device="cuda", writer_factory=None,
                show_progress: Optional[bool] = None,
                mesher: Optional[OOCMesher] = None) -> List[str]:
    """Full single-device reconstruction. Returns the output files (none
    when cfg.checkpoint is set)."""
    cfg.validate()
    check_supported(cfg)
    dev = resolve_device(str(device))
    require_native()
    misc.bound_mmap_threshold()  # keep cycling per-block buffers off brk
    stats = get_registry()
    show_progress = cfg.progress if show_progress is None else show_progress

    with stats.timer("pass0.time"):
        info = blobs_mod.compute_blobs(source, cfg.fit_grid, cfg.micro_cells,
                                       mem_budget=cfg.mem_blobs)
    if (info.micro_dims > bucket_mod.MAX_MICRO_GRID).any():
        raise MlsError(
            f"microblock grid {tuple(int(d) for d in info.micro_dims)} "
            f"exceeds {bucket_mod.MAX_MICRO_GRID} per axis: sparse bucketing "
            "is not yet ported (raise --leaf-cells or --fit-grid)")

    chunk_cells = None
    if cfg.output_split_size:
        # Output-chunk heuristic (src/mlsgpu_core.cpp:632-653), rounded up
        # to whole blocks so chunks align with bucket boundaries.
        chunk_cells = misc.round_up(
            int(np.ceil(np.sqrt(cfg.output_split_size / 760.0))),
            cfg.device_block_cells)
    max_splats = min(cfg.max_device_splats, cfg.mem_bucket_splats // 32)
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
            expected[b.chunk_id.coords] = expected.get(b.chunk_id.coords, 0) + 1
        mesher.enable_eager_write(output, expected,
                                  writer_factory=writer_factory)

    total = sum(b.num_splats for b in buckets)
    progress = (ProgressDisplay(total, label="reconstructing")
                if show_progress else NullProgress())

    with stats.timer("pass1.time"):
        mesher_worker = timeplot.Worker("mesher")

        def consume(bucket, result):
            block = block_result_to_input(result, bucket)
            with timeplot.Action("mesher", mesher_worker,
                                 stats.variable("mesher.time")):
                mesher.add(block)
            progress.add(bucket.num_splats)

        consume_threaded(stream_blocks(source, info, buckets, cfg, dev),
                         consume)

    if cfg.checkpoint:
        mesher.checkpoint(cfg.checkpoint)
        log.info(f"checkpointed mesher state to {cfg.checkpoint}")
        return []
    with stats.timer("write.time"):
        outputs = mesher.write(output, writer_factory=writer_factory,
                               split_size=cfg.output_split_size)
    mesher.cleanup()
    return outputs


def resume(checkpoint_path: str, cfg: ReconstructConfig, output: str,
           writer_factory=None) -> List[str]:
    """Write-only run from a checkpoint (--resume). Checkpoints are the
    shared mesher's files, so one written by the JAX package resumes here."""
    misc.bound_mmap_threshold()
    mesher = OOCMesher.resume(checkpoint_path)
    return mesher.write(output, writer_factory=writer_factory,
                        split_size=cfg.output_split_size)
