"""Streaming block executor (port of mlsgpu_tpu/pipeline/streamer.py):
a loader thread reads each bucket's blob ranges and converts them to block
inputs behind a bounded queue (for worker processes it reads them straight
into shared memory and each process converts its own: the parent's one
interpreter feeds N workers), device workers run the block step and start
each block's readback, a decode stage (a thread per worker) decodes each
finished block as soon as its images are on the host, the generator hands
the blocks out in the loader's order, and `consume_threaded` passes them to
the mesher on its own thread, which does nothing else: it is one thread,
as in the reference (src/mesher.cpp), and its input is order-dependent.
The native decodes release the interpreter lock, so the stage's threads
decode side by side.

Workers. A run has D devices x T queues (--num-devices, --device-threads).
One worker runs its block steps on a thread of this process, under
`torch.cuda.device`. With more than one, each worker runs in a process of
its own (pipeline/workers.py), the reference's several command queues per
device with a worker each (src/workers.h:183-206): an eager block step is
thousands of small calls with host synchronisations between them, and
threads of one interpreter hand its lock over at each (PERF.md), where
processes share none. Each worker process has a proxy thread here. A free
worker pulls the next loaded block, which is the reference's pull model
(src/workers.cpp:315-351) and the port's form of the JAX loop's
spare-capacity rule. The JAX loop's one dispatching thread is not carried
over: there a block step is one asynchronous call of a compiled program.

Order. The loader numbers the blocks and the generator yields them in that
order whichever worker finished first, so the mesher sees one order and
the output of any number of workers is bitwise the one-worker run's.

Host memory is bounded as in the JAX streamer (the reference's
CircularBuffer backpressure, src/circular_buffer.h:47-248), by the bytes
really held: --mem-load-splats bounds the splats loaded and not yet taken
by a worker, --mem-host-splats the splats held on the host from loading
until their block is launched, and --mem-mesh the readback images of all
workers together from the start of the copy until the block is yielded
(with worker processes these bytes are the shared buffers that carry a
block's splats to its worker and its images back), and with a decode
stage each block's decoded mesh too, admitted with its image from an upper
bound of its size (decoded_bytes), before it exists.
Each budget always admits one block; --mem-mesh always admits the oldest
block not yet yielded, or a full budget would wait on a block that waits
on the budget. The peaks are recorded as mem.loadQueue, mem.hostSplats and
mem.meshWindow, and the most --mem-mesh held for one block as the peak of
mem.meshBlock (so mem.meshWindow stays within --mem-mesh plus that).

What the JAX streamer needed only for XLA's static shapes is gone: no pow2
padding of splat batches, no sizing probe, no caps and no overflow retry
(the port sizes every device output from its true count), and no
speculative readback.
"""

from __future__ import annotations

import contextlib
import functools
import os
import queue
import threading
import time
from typing import (Callable, Dict, Iterable, Iterator, List, NamedTuple,
                    Optional, Sequence, Tuple, Union)

import numpy as np
import torch

from mlsgpu_tpu_torch.core.splat import block_inputs
from mlsgpu_tpu_torch.io.splat_set import SplatSource, merge_ranges
from mlsgpu_tpu_torch.utils import misc, step_profile, timeplot
from mlsgpu_tpu_torch.utils.statistics import Peak, get_registry

from mlsgpu_tpu_torch.ops import seam_cuda
from mlsgpu_tpu_torch.ops.block import (CountsView, Format, block_step,
                                        block_step_staged, readback_tensors)
from mlsgpu_tpu_torch.pipeline import workers as workers_mod

_SENTINEL = object()

# Return glibc-freed heap spans to the OS every N blocks (utils.misc).
_TRIM_EVERY = 8

#: Blocks one worker may have between the start of their step and their
#: yield: one readback in flight while the next block computes.
WORKER_WINDOW = 2


#: Host bytes of one splat of a block input: (8,) f32 row + valid byte.
SPLAT_BYTES = 8 * 4 + 1

#: The statistics counters of the field, face and skeleton kernels'
#: launches while a stream runs (seam_cuda.launch_counts order).
LAUNCH_COUNTERS = ("mls.launches", "seam.faceLaunches",
                   "seam.skeletonLaunches")


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


def bucket_ranges(info, b) -> List[Tuple[int, int]]:
    """A bucket's blobs' splat ranges, merged in ascending splat id, so
    two buckets list the splats they share in the same relative order: the
    stream order that the face and skeleton passes sum in (ops/mls.py)."""
    start, count = info.blobs.start, info.blobs.count
    return merge_ranges((int(start[i]), int(start[i] + count[i]))
                        for i in b.blob_ids)


def decoded_bytes(counts: np.ndarray) -> int:
    """An upper bound of the host bytes of a block's decoded mesh (the
    mesher's input: f32 vertices, i64 weld keys, i32 triangle indices)
    from its counts (ops.block.COUNTS_FIELDS): what a decode allocates in
    any readback mode (the codes rebuild sizes its outputs from the
    unwelded vertices and the indices)."""
    vertices = max(int(counts[0]), int(counts[5]), 1)
    return (3 * 4 + 8) * vertices + 4 * max(int(counts[2]), 3)


def decode_threads(workers: int) -> int:
    """Threads of a run's decode stage (stream_blocks): one per worker, at
    most half of the cores this process may run on."""
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count() or 2)
    return max(1, min(workers, cores // 2))


def load_bucket(source: SplatSource, info, b):
    """A bucket's block inputs (core.splat.block_inputs) from its splat
    ranges (bucket_ranges): what a worker thread takes."""
    stats = get_registry()
    with stats.timer("loader.read"):
        splats = source.read_ranges(bucket_ranges(info, b))
    with stats.timer("loader.convert"):
        return block_inputs(splats, info.grid)


def load_bucket_shared(source: SplatSource, info, b) -> torch.Tensor:
    """A bucket's world-frame splats from its ranges (bucket_ranges), read
    once, straight into a new shared-memory tensor: what a worker process
    takes, and converts itself (pipeline/workers.py)."""
    with get_registry().timer("loader.read"):
        ranges = bucket_ranges(info, b)
        out = torch.empty((sum(hi - lo for lo, hi in ranges), 8),
                          dtype=torch.float32).share_memory_()
        source.read_ranges_into(ranges, out.numpy())
    return out


def consume_threaded(pairs: Iterator, fn, depth: int = 2) -> None:
    """Run `fn(bucket, result)` on a consumer thread while the producer
    iterator keeps the device fed. `depth` bounds queued results.
    Exceptions on either side cancel the other and re-raise. Records
    consumer.busy, the consumer's seconds in `fn` per item, and
    consumer.wait, the producer's wait for room in the queue per item:
    while it waits, the producer (stream_blocks) yields nothing and frees
    no worker's slot."""
    stats = get_registry()
    busy, wait = stats.variable("consumer.busy"), stats.timer("consumer.wait")
    out_q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: List[BaseException] = []

    def consumer():
        while True:
            item = out_q.get()
            if item is _SENTINEL:
                return
            try:
                t0 = time.monotonic()
                fn(*item)
                busy.add(time.monotonic() - t0)
            except BaseException as e:  # re-raised on the producer side
                err.append(e)
                return

    t = threading.Thread(target=consumer, name="mesher", daemon=True)
    t.start()
    try:
        for pair in pairs:
            with wait:
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


class MeshWindow:
    """The finished blocks of all workers, handed out in the loader's order,
    and the --mem-mesh budget over their images, under one lock.

    A worker calls `admit(seq, nbytes)` before it starts a block's readback
    and `deposit(seq, entry)` after; the generator takes the blocks with
    `next_entry()` in sequence and calls `release(nbytes)` when it yields
    one. `admit` waits while the images held would exceed the budget,
    except for the oldest block not yet yielded, which always passes: every
    other block can wait for it, it for none."""

    def __init__(self, budget: int, peak: Peak, cancel: threading.Event):
        self.budget = int(budget)
        self.peak = peak
        self.cancel = cancel
        self.held = 0
        self.next_seq = 0                 # oldest block not yet yielded
        self.total: Optional[int] = None  # blocks in all, once known
        self._ready: Dict[int, tuple] = {}
        self._cond = threading.Condition()

    def admit(self, seq: int, nbytes: int) -> bool:
        with self._cond:
            while seq != self.next_seq and self.held + nbytes > self.budget:
                if self.cancel.is_set():
                    return False
                self._cond.wait(0.2)
            self.held += nbytes
            self.peak.set(self.held)
            return True

    def deposit(self, seq: int, entry: tuple) -> None:
        with self._cond:
            self._ready[seq] = entry
            self._cond.notify_all()

    def finish(self, total: int) -> None:
        """The loader has numbered its last block."""
        with self._cond:
            self.total = total
            self._cond.notify_all()

    def wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def next_entry(self):
        """The next block in order, or None when all have been handed out
        or the run is cancelled."""
        with self._cond:
            while self.next_seq not in self._ready:
                if self.cancel.is_set() or self.next_seq == self.total:
                    return None
                self._cond.wait(0.2)
            return self._ready.pop(self.next_seq)

    def release(self, nbytes: int) -> None:
        """The block `next_entry` returned is about to be yielded."""
        with self._cond:
            self.held -= nbytes
            self.next_seq += 1
            self.peak.set(self.held)
            self._cond.notify_all()


def _start_readback(tensors: List[torch.Tensor], device: torch.device):
    """Queue the copy of a block's readback tensors to the host on the
    current stream of `device`; returns (host tensors, event). On the card
    each copy lands in pinned memory asynchronously and the event marks
    their completion; on the CPU the tensors are already the host's and
    the event is None."""
    if device.type != "cuda":
        return tensors, None
    hosts = []
    with torch.cuda.device(device):
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


def device_workers(devices: Sequence[torch.device], queues: int):
    """One (device, position of the device in `devices`, queue) per
    worker: `queues` workers for every entry of `devices`."""
    return [(dev, pos, q) for pos, dev in enumerate(devices)
            for q in range(queues)]


def _step_and_args(cfg, readback: str, device_filter,
                   step: Optional[Callable]) -> Tuple[Callable, Dict]:
    """A run's block step and its keyword arguments: they depend on the
    configuration alone, not on the blocks."""
    if step is None:
        step = block_step_staged if cfg.statistics_device else block_step
    return step, dict(boundary_factor=float(cfg.boundary_factor),
                      levels=cfg.device_levels, subsampling=cfg.subsampling,
                      fit_shape=cfg.fit_shape, readback=readback,
                      device_filter=device_filter)


def start_stream_workers(cfg, devices: Sequence[torch.device], readback: str,
                         device_filter=None, read_images: bool = True,
                         step: Optional[Callable] = None
                         ) -> Optional[List[workers_mod.WorkerProcess]]:
    """Start the worker processes of a run on `devices` before its blob
    pass, so that their start (the worker server's imports, a fork, a CUDA
    context, the kernel library: pipeline/worker_start.py) runs beside that
    pass and bucketing, without waiting for it; None when the run
    has one worker, which stream_blocks runs in a thread. The arguments are
    stream_blocks' own. The caller hands the group to
    stream_blocks(group=) and ends it with workers.stop_workers however
    the run ends."""
    workers = device_workers(list(devices), max(1, int(cfg.device_threads)))
    if not workers_mod.uses_processes(len(workers)):
        return None
    step, step_args = _step_and_args(cfg, readback, device_filter, step)
    return workers_mod.start_workers(workers, step, step_args, read_images)


def stream_blocks(source: SplatSource, info, buckets: Iterable, cfg,
                  devices: Union[torch.device, Sequence[torch.device]],
                  readback: str, device_filter=None,
                  read_images: bool = True,
                  step: Optional[Callable] = None,
                  group: Optional[List[workers_mod.WorkerProcess]] = None,
                  decode: Optional[Callable] = None) -> Iterator[tuple]:
    """Yield (bucket, HostBlock) for every bucket in the loader's order,
    pipelined: loading runs ahead on a thread, every device of `devices`
    has max(1, --device-threads) workers (module docstring), and every
    worker has up to WORKER_WINDOW blocks between the start of their step
    and their yield, fewer when the images would exceed --mem-mesh.

    `decode(HostBlock, bucket)`, when given, runs on a stage of
    decode_threads(workers) threads of its own, on each block as soon as
    its images are on the host, whichever block comes first; the generator
    then yields (bucket, what `decode` returned), still in the loader's
    order. --mem-mesh then also counts each block's decoded bytes
    (decoded_bytes, an upper bound from its counts), admitted with its
    image, so that a block whose decode finished early waits in the
    budget. An exception in a decode ends the run as one in a worker does.

    `devices` is one device or a sequence; a sequence may name a device
    more than once (each entry gets its own workers). `buckets` is any
    iterable, drawn from by the loader alone and possibly lazy: a
    distributed run passes its work queue, which claims chunks at the
    loader's pace, so claim-ahead is bounded by the workers and the byte
    budgets. (The JAX package takes the list and a separate `bucket_iter=`;
    here the one argument carries either.) With `read_images` false no
    image is copied to the host and every HostBlock carries its counts
    alone (tools/bench_split's compute-only pass).

    `readback` is the resolved mode ("codes", "packed" or "raw"; "raw"
    when `device_filter` is set). With --statistics-device every block step
    is timed stage by stage (ops.block.block_step_staged). `step` replaces
    the block step (ops.block.block_step's signature); a worker process
    imports it by name, so it is a module-level callable. `group` is the
    run's worker processes from start_stream_workers (same arguments),
    which the caller stops; without it the processes start here, after the
    loader, and stop here. No worker pulls a block before every process of
    the group is ready; workers.readyWait is the seconds this waited. An
    exception in the loader or in any worker cancels the others and is
    raised here; closing the generator joins every thread and ends every
    worker process it started."""
    stats = get_registry()
    if isinstance(devices, torch.device):
        devices = [devices]
    workers = device_workers(list(devices), max(1, int(cfg.device_threads)))
    misc.bound_mmap_threshold()
    step, step_args = _step_and_args(cfg, readback, device_filter, step)
    if group is not None and len(group) != len(workers):
        raise ValueError(f"{len(group)} worker processes for "
                         f"{len(workers)} workers")
    processes = workers_mod.uses_processes(len(workers))
    load_q: "queue.Queue" = queue.Queue(maxsize=max(2, len(workers)) + 1)
    error: List[BaseException] = []
    cancel = threading.Event()
    load_budget = ByteBudget(cfg.mem_load_splats,
                             stats.peak("mem.loadQueue"), cancel)
    host_budget = ByteBudget(cfg.mem_host_splats,
                             stats.peak("mem.hostSplats"), cancel)
    window = MeshWindow(cfg.mem_mesh, stats.peak("mem.meshWindow"), cancel)
    largest = stats.peak("mem.meshBlock")
    decode_q: "queue.Queue" = queue.Queue()   # bounded by the slots
    # a worker's wait for a free slot of its window (one per block it
    # pulls: its blocks not yet yielded hold them), for a loaded block,
    # and a proxy's for its process
    slot_wait = stats.timer("workers.slotWait")
    block_wait = stats.timer("workers.blockWait")
    proxy_wait = stats.timer("workers.proxyWait")

    def fail(e: BaseException) -> None:
        error.append(e)
        cancel.set()
        window.wake()

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
        seq = 0
        try:
            for b in buckets:
                nbytes = b.num_splats * SPLAT_BYTES
                if not (host_budget.acquire(nbytes)
                        and load_budget.acquire(nbytes)):
                    return
                with timeplot.Action("load", worker,
                                     stats.variable("loader.time")):
                    if processes:   # a worker process converts its own
                        splats, valid = load_bucket_shared(source, info,
                                                           b), None
                    else:
                        splats, valid = load_bucket(source, info, b)
                if not _put((seq, b, nbytes, splats, valid)):
                    return
                seq += 1
            window.finish(seq)
        except BaseException as e:  # raised by the generator
            fail(e)
        finally:
            _put(_SENTINEL)

    def region_of(b):
        return (tuple(int(v) for v in b.cell_hi - b.cell_lo),
                tuple(int(v) for v in b.cell_lo))

    def run_here(device, plot, profiler, taken: list):
        """One block on this thread: h2d, the step and the start of its
        readback; the entry for the generator. `taken` holds the loader's
        item and is emptied, so the host copy of the splats goes as soon
        as it is on the device."""
        seq, b, nbytes, splats, valid = taken.pop()
        load_budget.release(nbytes)
        t0 = time.monotonic()
        with timeplot.Action("compute", plot, stats.variable("device.time")), \
                (torch.cuda.device(device) if device.type == "cuda"
                 else contextlib.nullcontext()):
            sp, va, pts = workers_mod.to_device(device, splats, valid,
                                                b.skeleton)
            del splats, valid
            with profiler.step():
                result = step(sp, va, *region_of(b), points=pts,
                              **step_args)
            del sp, va, pts
        host_budget.release(nbytes)
        tensors = readback_tensors(result) if read_images else []
        image_bytes = sum(t.numel() * t.element_size() for t in tensors)
        held = window_bytes(image_bytes, result.counts)
        if not window.admit(seq, held):
            return None
        hosts, event = _start_readback(tensors, device)
        stats.variable("device.occTiles").add(result.num_occ_tiles)
        stats.counter(f"readback.mode.{result.readback}").add(1)
        # the device tensors stay referenced until their copy is done
        return seq, (b, result.readback, result.fmt, result.counts, hosts,
                     event, tensors, image_bytes, held), \
            time.monotonic() - t0

    def run_in(proc, taken: list):
        """One block in worker process `proc` (pipeline/workers.py's round
        trip); the same entry, its images already on the host."""
        seq, b, nbytes, splats, valid = taken.pop()
        load_budget.release(nbytes)
        t0 = time.monotonic()
        proc.send_block(splats, info.grid, b.skeleton, *region_of(b))
        del splats, valid
        with proxy_wait:
            msg = proc.recv(cancel)
        if msg is None:
            return None
        _, counts, mode, fmt, image_bytes = msg
        host_budget.release(nbytes)
        held = window_bytes(image_bytes, counts)
        if not window.admit(seq, held):
            return None
        proc.send("read")
        with proxy_wait:
            msg = proc.recv(cancel)
        if msg is None:
            return None
        _, hosts, delta, c0, c1, launches = msg
        workers_mod.merge_stat_delta(delta)
        timeplot.record(proc.name, "compute", c0, c1)
        seam_cuda.add_launch_counts(launches)
        return seq, (b, mode, fmt, counts, hosts, None, None, image_bytes,
                     held), time.monotonic() - t0

    def window_bytes(image_bytes: int, counts) -> int:
        """What --mem-mesh holds for a block from the start of its copy
        to its yield: its images, and with a decode stage its decoded
        mesh."""
        held = image_bytes + (0 if decode is None
                              else decoded_bytes(counts))
        largest.set(held)
        return held

    def to_host(entry, plot):
        """A deposited entry once its images are on the host: (bucket,
        HostBlock, the bytes --mem-mesh holds for it, its worker's
        slots)."""
        b, mode, fmt, counts, hosts, event, _, image_bytes, held, slots = \
            entry
        with timeplot.Action("readback", plot,
                             stats.variable("readback.wait")):
            if event is not None:
                event.synchronize()
        stats.counter("readback.bytes").add(image_bytes)
        return b, HostBlock(readback=mode, fmt=fmt, counts=counts,
                            arrays=(_host_arrays(mode, hosts)
                                    if read_images else ())), held, slots

    def decoder(plot):
        """A thread of the decode stage: the finished blocks of every
        worker, in the order they finish; each result goes to the window,
        which hands them out in the loader's order."""
        try:
            while not cancel.is_set():
                try:
                    seq, entry = decode_q.get(timeout=0.2)
                except queue.Empty:
                    continue
                b, block, held, slots = to_host(entry, plot)
                del entry
                with timeplot.Action("decode", plot):
                    out = decode(block, b)
                del block
                window.deposit(seq, (b, out, held, slots))
                del out
        except BaseException as e:  # raised by the generator
            fail(e)

    finished = (window.deposit if decode is None
                else lambda seq, entry: decode_q.put((seq, entry)))

    def worker(pos, q, run, slots, profiler):
        blocks = stats.counter(f"device.blocks.{pos}.{q}")
        seconds = stats.variable(f"device.workerTime.{pos}.{q}")
        try:
            while True:
                # a slot first: a worker whose window is full leaves the
                # next block to a free one
                with slot_wait:
                    while not slots.acquire(timeout=0.2):
                        if cancel.is_set():
                            return
                item = _SENTINEL
                with block_wait:
                    while not cancel.is_set():
                        try:
                            item = load_q.get(timeout=0.2)
                            break
                        except queue.Empty:
                            continue
                if item is _SENTINEL:
                    _put(_SENTINEL)   # for the next worker
                    return
                taken = [item]
                del item
                done = run(taken)
                if done is None:
                    return
                seq, entry, dt = done
                blocks.add(1)
                seconds.add(dt)
                finished(seq, entry + (slots,))
                del done, entry
        except BaseException as e:  # raised by the generator
            fail(e)
        finally:
            if profiler is not None:
                profiler.close()

    owned: List[workers_mod.WorkerProcess] = []
    launched = seam_cuda.launch_counts()
    threads = [threading.Thread(target=loader, name="loader", daemon=True)]
    wait_plot = timeplot.Worker("readback")
    yielded = 0
    try:
        threads[0].start()   # loading runs ahead while the workers start
        if processes:
            procs = group
            if procs is None:
                procs = owned = workers_mod.start_workers(
                    workers, step, step_args, read_images)
            # all start together; none pulls a block before the slowest is
            # ready, so a late start leaves no worker without blocks
            with stats.timer("workers.readyWait"):
                for proc in procs:
                    proc.wait_ready(cancel)
            # a worker process traces its own steps (step_profile)
            runs = [(pos, q, proc.name, functools.partial(run_in, proc),
                     None) for (_, pos, q), proc in zip(workers, procs)]
        else:
            (dev, pos, q), = workers
            plot = timeplot.Worker(f"device.{pos}.{q}")
            profiler = step_profile.StepProfiler(plot.name)
            runs = [(pos, q, plot.name,
                     functools.partial(run_here, dev, plot, profiler),
                     profiler)]
        for pos, q, name, run, profiler in runs:
            threads.append(threading.Thread(
                target=worker, name=name, daemon=True,
                args=(pos, q, run, threading.Semaphore(WORKER_WINDOW),
                      profiler)))
            threads[-1].start()
        if decode is not None:
            n = decode_threads(len(workers))
            stats.counter("readback.decodeThreads").add(n)
            for i in range(n):
                plot = timeplot.Worker("decode", i)
                threads.append(threading.Thread(
                    target=decoder, name=plot.name, daemon=True,
                    args=(plot,)))
                threads[-1].start()
        while True:
            entry = None if error else window.next_entry()
            if error:
                raise error[0]
            if entry is None:
                break
            b, block, held, slots = (entry if decode is not None
                                     else to_host(entry, wait_plot))
            del entry
            window.release(held)
            slots.release()
            yield b, block
            del block
            yielded += 1
            if yielded % _TRIM_EVERY == 0:
                misc.malloc_trim()
        misc.malloc_trim()
    finally:
        cancel.set()
        window.wake()
        for t in threads:
            if t.ident is not None:
                t.join()
        workers_mod.stop_workers(owned)
        # the kernels' launches in this process and its worker processes
        # while the stream ran, for a caller that reads the statistics
        for name, a, b in zip(LAUNCH_COUNTERS, launched,
                              seam_cuda.launch_counts()):
            stats.counter(name).add(b - a)
