"""Streaming block executor (port of mlsgpu_tpu/pipeline/streamer.py):
a loader thread reads each bucket's blob ranges and converts them to block
inputs behind a bounded queue, the main thread runs the block step on the
device and keeps a small window of blocks whose readback is in flight, and
`consume_threaded` hands finished blocks to the mesher on its own thread.

What the JAX streamer needed only for XLA's static shapes is gone: no pow2
padding of splat batches, no sizing probe, no caps and no overflow retry
(the port sizes every device output from its true count), and no
speculative readback.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from mlsgpu_tpu.core.splat import SplatArray
from mlsgpu_tpu.io.splat_set import SplatSource, merge_ranges
from mlsgpu_tpu.utils import misc, timeplot
from mlsgpu_tpu.utils.statistics import get_registry

from mlsgpu_tpu_torch.ops.block import (BlockResult, CodesFormat,
                                        block_step, codes_format)

_SENTINEL = object()

# Return glibc-freed heap spans to the OS every N blocks (utils.misc).
_TRIM_EVERY = 8


class HostCodes(NamedTuple):
    """A finished block on the host: the codes image and its counts."""
    packed: np.ndarray         # (words,) uint32, CodesFormat layout
    fmt: CodesFormat
    num_cells: int
    num_unwelded: int
    num_indices: int


def prepare_block_inputs(splats: np.ndarray, grid):
    """World-frame splats -> (grid-frame (N, 8) f32 with col 3 = radius in
    cells, valid (N,) bool). Splats stay in the global grid frame: block-
    dependent f32 rounding would break cross-block determinism."""
    arr = SplatArray(splats)
    grid_form = arr.to_grid_frame(grid)
    # to_grid_frame put 1/r^2 in col 3; binning wants the radius.
    grid_form[:, 3] = splats[:, 3] / np.float32(grid.spacing)
    return grid_form, arr.is_finite()


def consume_threaded(pairs: Iterator, fn, depth: int = 2) -> None:
    """Run `fn(bucket, result)` on a consumer thread while the producer
    iterator keeps the device fed. `depth` bounds queued results.
    Exceptions on either side cancel the other and re-raise."""
    out_q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: List[BaseException] = []

    def consumer():
        while True:
            item = out_q.get()
            if item is _SENTINEL:
                return
            try:
                fn(*item)
            except BaseException as e:  # re-raised on the producer side
                err.append(e)
                return

    t = threading.Thread(target=consumer, name="mesher", daemon=True)
    t.start()
    try:
        for pair in pairs:
            while not err:
                try:
                    out_q.put(pair, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if err:
                break
    finally:
        close = getattr(pairs, "close", None)
        if close is not None:
            close()  # run the producer's cleanup (loader join) promptly
        while not err:
            try:
                out_q.put(_SENTINEL, timeout=0.2)
                break
            except queue.Full:
                continue
        t.join()
    if err:
        raise err[0]


def _start_readback(result: BlockResult, device: torch.device):
    """Queue the copy of the codes image to the host; returns (host tensor,
    event or None). On the card the copy lands in pinned memory
    asynchronously; the event marks its completion."""
    if device.type != "cuda":
        return result.packed, None
    host = torch.empty(result.packed.shape, dtype=result.packed.dtype,
                       pin_memory=True)
    host.copy_(result.packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def stream_blocks(source: SplatSource, info, buckets: Sequence, cfg,
                  device: torch.device) -> Iterator[Tuple[object, HostCodes]]:
    """Yield (bucket, HostCodes) for every bucket, pipelined: loading runs
    ahead on a thread, and up to max(2, --device-threads) blocks have
    readbacks in flight (the reference's per-device command queues)."""
    stats = get_registry()
    window = max(2, int(cfg.device_threads))
    misc.bound_mmap_threshold()
    fmt = codes_format(cfg.device_levels, cfg.subsampling)
    maxn = max((b.num_splats for b in buckets), default=1)
    block_bytes = maxn * (8 * 4 + 1)
    q_budget = max(1, int(cfg.mem_load_splats) // block_bytes)
    load_q: "queue.Queue" = queue.Queue(maxsize=min(window + 1, q_budget))
    blob_start = info.blobs.start
    blob_count = info.blobs.count
    grid = info.grid
    error: List[BaseException] = []
    cancel = threading.Event()

    def _put(item) -> bool:
        while not cancel.is_set():
            try:
                load_q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def loader():
        worker = timeplot.Worker("loader")
        try:
            for b in buckets:
                if cancel.is_set():
                    return
                with timeplot.Action("load", worker,
                                     stats.variable("loader.time")):
                    ranges = merge_ranges(
                        (int(blob_start[i]), int(blob_start[i] + blob_count[i]))
                        for i in b.blob_ids)
                    splats, valid = prepare_block_inputs(
                        source.read_ranges(ranges), grid)
                if not _put((b, splats, valid)):
                    return
        except BaseException as e:  # re-raised by the consumer loop
            error.append(e)
        finally:
            _put(_SENTINEL)

    thread = threading.Thread(target=loader, name="loader", daemon=True)
    thread.start()
    compute_worker = timeplot.Worker("device")
    inflight: deque = deque()

    def force(entry):
        b, result, host, event = entry
        with timeplot.Action("readback", compute_worker,
                             stats.variable("readback.wait")):
            if event is not None:
                event.synchronize()
        packed = host.numpy().view(np.uint32)
        stats.counter("readback.bytes").add(packed.nbytes)
        return b, HostCodes(packed=packed, fmt=fmt,
                            num_cells=result.num_cells,
                            num_unwelded=result.num_unwelded,
                            num_indices=result.num_indices)

    forced = 0
    try:
        while True:
            item = load_q.get()
            if item is _SENTINEL:
                if error:
                    raise error[0]
                break
            b, splats, valid = item
            with timeplot.Action("compute", compute_worker,
                                 stats.variable("device.time")):
                with stats.timer("dispatch.h2d"):
                    pts = (None if b.skeleton is None or not len(b.skeleton)
                           else torch.as_tensor(b.skeleton, device=device))
                    sp = torch.as_tensor(splats).to(device)
                    va = torch.as_tensor(valid).to(device)
                result = block_step(
                    sp, va, tuple(int(v) for v in b.cell_hi - b.cell_lo),
                    tuple(int(v) for v in b.cell_lo),
                    float(cfg.boundary_factor), pts,
                    levels=cfg.device_levels, subsampling=cfg.subsampling,
                    fit_shape=cfg.fit_shape)
                host, event = _start_readback(result, device)
            stats.variable("device.occTiles").add(result.num_occ_tiles)
            inflight.append((b, result, host, event))
            if len(inflight) > window:
                yield force(inflight.popleft())
                forced += 1
                if forced % _TRIM_EVERY == 0:
                    misc.malloc_trim()
        while inflight:
            yield force(inflight.popleft())
        misc.malloc_trim()
    finally:
        cancel.set()
        thread.join()
