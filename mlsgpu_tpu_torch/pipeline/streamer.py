"""Streaming block executor (port of mlsgpu_tpu/pipeline/streamer.py):
a loader thread reads each bucket's blob ranges and converts them to block
inputs behind a bounded queue, the main thread runs the block step on the
device and keeps a small window of blocks whose readback is in flight, and
`consume_threaded` hands finished blocks to the mesher on its own thread.

Host memory is bounded as in the JAX streamer (the reference's
CircularBuffer backpressure, src/circular_buffer.h:47-248), by the bytes
really held: --mem-load-splats bounds the splats loaded and not yet taken
by the device loop, --mem-host-splats the splats held on the host from
loading until their block is launched, and --mem-mesh the readback images
in flight. Each budget always admits one block. The peaks are recorded as
mem.loadQueue, mem.hostSplats and mem.meshWindow.

What the JAX streamer needed only for XLA's static shapes is gone: no pow2
padding of splat batches, no sizing probe, no caps and no overflow retry
(the port sizes every device output from its true count), and no
speculative readback.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Iterable, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from mlsgpu_tpu_torch.core.splat import SplatArray
from mlsgpu_tpu_torch.io.splat_set import SplatSource, merge_ranges
from mlsgpu_tpu_torch.utils import misc, timeplot
from mlsgpu_tpu_torch.utils.statistics import Peak, get_registry

from mlsgpu_tpu_torch.ops.block import (CountsView, Format, block_step,
                                        block_step_staged, readback_tensors)

_SENTINEL = object()

# Return glibc-freed heap spans to the OS every N blocks (utils.misc).
_TRIM_EVERY = 8


#: Host bytes of one splat of a block input: (8,) f32 row + valid byte.
SPLAT_BYTES = 8 * 4 + 1


class _HostBlock(NamedTuple):
    readback: str
    fmt: Format
    counts: np.ndarray         # (8,) int64, ops.block.COUNTS_FIELDS order
    arrays: Tuple[np.ndarray, ...]


class HostBlock(CountsView, _HostBlock):
    """A finished block on the host: its readback in the block's mode.

    codes / packed: arrays = (image (words,) uint32,) in `fmt`'s layout;
    raw: arrays = (vertices (nw, 3) f32 block-local, key_hi and key_lo of
    the external vertices (nw - fe,) uint32, triangles (nt, 3) int32)."""
    __slots__ = ()

    @property
    def packed(self) -> np.ndarray:
        return self.arrays[0]


class ByteBudget:
    """Bytes held against a budget, mirrored in a statistics Peak.
    `acquire` waits while holding n more bytes would exceed the budget,
    except when nothing is held (one item always passes); it gives up and
    returns False once `cancel` is set."""

    def __init__(self, budget: int, peak: Peak, cancel: threading.Event):
        self.budget = int(budget)
        self.peak = peak
        self.cancel = cancel
        self.held = 0
        self._cond = threading.Condition()

    def acquire(self, n: int) -> bool:
        with self._cond:
            while self.held and self.held + n > self.budget:
                if self.cancel.is_set():
                    return False
                self._cond.wait(0.2)
            self.held += n
            self.peak.set(self.held)
            return True

    def release(self, n: int) -> None:
        with self._cond:
            self.held -= n
            self.peak.set(self.held)
            self._cond.notify_all()


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


def _start_readback(tensors: List[torch.Tensor], device: torch.device):
    """Queue the copy of a block's readback tensors to the host; returns
    (host tensors, event or None). On the card each copy lands in pinned
    memory asynchronously and the event marks their completion; on the CPU
    the tensors are already the host's."""
    if device.type != "cuda":
        return tensors, None
    hosts = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        hosts.append(h)
    event = torch.cuda.Event()
    event.record()
    return hosts, event


def _host_arrays(readback: str, hosts: List[torch.Tensor]):
    if readback != "raw":
        return (hosts[0].numpy().view(np.uint32),)
    verts, hi, lo, tris = (h.numpy() for h in hosts)
    return verts, hi.view(np.uint32), lo.view(np.uint32), tris


def stream_blocks(source: SplatSource, info, buckets: Iterable, cfg,
                  device: torch.device, readback: str, device_filter=None,
                  read_images: bool = True) -> Iterator[Tuple[object, HostBlock]]:
    """Yield (bucket, HostBlock) for every bucket, pipelined: loading runs
    ahead on a thread, and up to max(2, --device-threads) blocks have
    readbacks in flight (the reference's per-device command queues), fewer
    when their images would exceed --mem-mesh.

    `buckets` is any iterable, drawn from by the loader alone and possibly
    lazy: a distributed run passes its work queue, which claims chunks at
    the loader's pace, so claim-ahead is bounded by the window and the byte
    budgets. (The JAX package takes the list and a separate `bucket_iter=`;
    here the one argument carries either.) With
    `read_images` false no image is copied to the host and every HostBlock
    carries its counts alone (tools/bench_split's compute-only pass).

    `readback` is the resolved mode ("codes", "packed" or "raw"; "raw"
    when `device_filter` is set). With --statistics-device every block step
    is timed stage by stage (ops.block.block_step_staged)."""
    stats = get_registry()
    window = max(2, int(cfg.device_threads))
    misc.bound_mmap_threshold()
    step = block_step_staged if cfg.statistics_device else block_step
    load_q: "queue.Queue" = queue.Queue(maxsize=window + 1)
    blob_start = info.blobs.start
    blob_count = info.blobs.count
    grid = info.grid
    error: List[BaseException] = []
    cancel = threading.Event()
    load_budget = ByteBudget(cfg.mem_load_splats,
                             stats.peak("mem.loadQueue"), cancel)
    host_budget = ByteBudget(cfg.mem_host_splats,
                             stats.peak("mem.hostSplats"), cancel)
    pk_mesh = stats.peak("mem.meshWindow")
    mesh_bytes = [0]                   # images in flight

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
                nbytes = b.num_splats * SPLAT_BYTES
                if not (host_budget.acquire(nbytes)
                        and load_budget.acquire(nbytes)):
                    return
                with timeplot.Action("load", worker,
                                     stats.variable("loader.time")):
                    ranges = merge_ranges(
                        (int(blob_start[i]), int(blob_start[i] + blob_count[i]))
                        for i in b.blob_ids)
                    splats, valid = prepare_block_inputs(
                        source.read_ranges(ranges), grid)
                if not _put((b, nbytes, splats, valid)):
                    return
        except BaseException as e:  # re-raised by the consumer loop
            error.append(e)
        finally:
            _put(_SENTINEL)

    thread = threading.Thread(target=loader, name="loader", daemon=True)
    thread.start()
    compute_worker = timeplot.Worker("device")
    inflight: deque = deque()          # (bucket, result, hosts, event, bytes)

    def force(entry):
        b, result, hosts, event, nbytes = entry
        with timeplot.Action("readback", compute_worker,
                             stats.variable("readback.wait")):
            if event is not None:
                event.synchronize()
        stats.counter("readback.bytes").add(nbytes)
        mesh_bytes[0] -= nbytes
        pk_mesh.set(mesh_bytes[0])
        return b, HostBlock(readback=result.readback, fmt=result.fmt,
                            counts=result.counts,
                            arrays=(_host_arrays(result.readback, hosts)
                                    if read_images else ()))

    forced = 0
    try:
        while True:
            item = load_q.get()
            if item is _SENTINEL:
                if error:
                    raise error[0]
                break
            b, nbytes, splats, valid = item
            load_budget.release(nbytes)
            with timeplot.Action("compute", compute_worker,
                                 stats.variable("device.time")):
                with stats.timer("dispatch.h2d"):
                    pts = (None if b.skeleton is None or not len(b.skeleton)
                           else torch.as_tensor(b.skeleton, device=device))
                    sp = torch.as_tensor(splats).to(device)
                    va = torch.as_tensor(valid).to(device)
                del item, splats, valid
                result = step(
                    sp, va, tuple(int(v) for v in b.cell_hi - b.cell_lo),
                    tuple(int(v) for v in b.cell_lo),
                    float(cfg.boundary_factor), pts,
                    levels=cfg.device_levels, subsampling=cfg.subsampling,
                    fit_shape=cfg.fit_shape, readback=readback,
                    device_filter=device_filter)
                del sp, va, pts
            host_budget.release(nbytes)
            tensors = readback_tensors(result) if read_images else []
            image_bytes = sum(t.numel() * t.element_size() for t in tensors)
            # --mem-mesh: make room for this block's image first, keeping
            # at least this block in flight.
            while inflight and mesh_bytes[0] + image_bytes > cfg.mem_mesh:
                yield force(inflight.popleft())
                forced += 1
            hosts, event = _start_readback(tensors, device)
            mesh_bytes[0] += image_bytes
            pk_mesh.set(mesh_bytes[0])
            stats.variable("device.occTiles").add(result.num_occ_tiles)
            stats.counter(f"readback.mode.{readback}").add(1)
            inflight.append((b, result, hosts, event, image_bytes))
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
