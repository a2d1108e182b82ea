"""Device workers as processes: the port's counterpart of the reference's
DeviceWorkerGroup (src/workers.h:183-206, src/workers.cpp:315-351).

A run with more than one worker (D devices x T --device-threads) runs
each worker's block steps in a process of its own. An eager block step is
thousands of small PyTorch calls with host synchronisations between them;
several threads of one interpreter hand its lock over at every call, and
measured slower than one (PERF.md), while processes share no lock. A run
with one worker keeps its block steps in the streamer's own thread.

The parent (pipeline/streamer.py) keeps the loader, the byte budgets, the
ordered yield and the cancel flag; each worker has a thin proxy thread
there that pulls a block, hands it to its process and deposits the result.
`WorkerProcess` is that proxy's end; `_worker_main` the process's.

A block's round trip over the worker's pipe:

    parent -> ("block", splats, valid, skeleton points, region, origin)
    child  -> ("counts", counts, readback mode, fmt, image bytes)
    parent -> ("read",)       once --mem-mesh admits the image
    child  -> ("done", host images, statistics, start, end, launches)

Tensors in these messages travel through shared memory (torch's file
descriptor sharing), not through the pipe. The child copies its readback
images from the device into fresh shared tensors, which the parent hands
to the mesher as they are. ("stop",) ends a process at any point; a child
that fails sends ("error", exception, traceback) and exits.

A process is started with the spawn method (the parent has touched CUDA),
sets its card, FP32 precision and a small intra-op thread count, and
loads the MLS kernel library before it reports ready. A process that
cannot do so, or that raises or dies later, ends the run: no block is ever
run in the parent or on the CPU in its place.

Spawning also starts Python's resource tracker, a process that would live
as long as this one. When the last group of workers has stopped, the
tracker is stopped too if it was their start that launched it, so that no
process of a run outlives it.
"""

from __future__ import annotations

import pickle
import signal
import threading
import time
import traceback
from multiprocessing import connection, resource_tracker
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.multiprocessing

from mlsgpu_tpu_torch.device import set_precision
from mlsgpu_tpu_torch.ops import mls_cuda
from mlsgpu_tpu_torch.ops.block import readback_tensors
from mlsgpu_tpu_torch.utils import misc
from mlsgpu_tpu_torch.utils.errors import MlsError
from mlsgpu_tpu_torch.utils.statistics import (Registry, TimerStat, Variable,
                                               get_registry, set_registry)

#: Device memory one worker process holds on its card besides its block
#: steps: its CUDA context with the kernel library loaded. An upper bound
#: of what chip_smoke.py phase 14 measures for an idle worker (the drop of
#: the card's free memory; PERF.md gives it with the card's name).
WORKER_CONTEXT_BYTES = 768 << 20

#: Seconds a stopped worker gets to exit before it is terminated, and a
#: terminated one before it is killed.
STOP_S = 5.0

# Return glibc-freed heap spans to the OS every N blocks (utils.misc).
_TRIM_EVERY = 8

# Groups of workers alive in this process, and whether the first of them
# launched the resource tracker (module docstring).
_groups_lock = threading.Lock()
_groups = 0
_own_tracker = False


class WorkerDied(MlsError):
    """A worker process ended without being asked to."""


def uses_processes(workers: int) -> bool:
    """Whether a run of `workers` workers runs them as processes."""
    return workers > 1


def to_device(device: torch.device, splats: np.ndarray, valid: np.ndarray,
              points: Optional[np.ndarray]):
    """One block's inputs on `device`, timed as dispatch.h2d."""
    with get_registry().timer("dispatch.h2d"):
        pts = (None if points is None or not len(points)
               else torch.as_tensor(points, device=device))
        return (torch.as_tensor(splats).to(device),
                torch.as_tensor(valid).to(device), pts)


def _shared(a) -> torch.Tensor:
    """A copy of array or tensor `a` in shared memory."""
    t = torch.as_tensor(a)
    out = torch.empty(t.shape, dtype=t.dtype).share_memory_()
    out.copy_(t)
    return out


def _stat_delta(reg: Registry) -> List[tuple]:
    """A registry's counters and variables as (kind, name, state)."""
    out = []
    for s in reg:
        d = s.to_dict()
        if d["type"] == "counter":
            out.append(("counter", s.name, d["total"]))
        elif d["type"] == "variable":
            out.append(("timer" if isinstance(s, TimerStat) else "variable",
                        s.name, (d["n"], d["sum"], d["sum2"])))
    return out


def merge_stat_delta(delta: List[tuple]) -> None:
    """Add a worker's statistics (_stat_delta) to this process's registry
    under the same names."""
    stats = get_registry()
    for kind, name, state in delta:
        if kind == "counter":
            stats.counter(name).add(state)
            continue
        other = Variable(name)
        other.n, other.sum, other.sum2 = state
        (stats.timer(name) if kind == "timer"
         else stats.variable(name)).merge(other)


def _portable(e: BaseException) -> BaseException:
    """`e` if it survives pickling, else a RuntimeError with its text."""
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")


def _worker_main(conn, name: str, device: torch.device, step: Callable,
                 step_args: Dict, threads: int, read_images: bool) -> None:
    """A worker process: set up, report ready, then run blocks until told
    to stop or until the parent's end of the pipe closes."""
    entered = time.monotonic()  # the interpreter is up, the modules imported
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # the parent stops us
    try:
        torch.set_num_threads(threads)
        misc.bound_mmap_threshold()
        if device.type == "cuda":
            torch.cuda.set_device(device)
            mls_cuda.load()
        set_precision()
        conn.send(("ready", entered, time.monotonic()))
        done = 0
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                return
            _, splats, valid, points, region, origin = msg
            del msg
            reg = Registry()
            set_registry(reg)
            launched = mls_cuda.launches
            t0 = time.monotonic()
            sp, va, pts = to_device(device, splats, valid, points)
            del splats, valid, points
            result = step(sp, va, region, origin, points=pts, **step_args)
            del sp, va, pts
            t1 = time.monotonic()
            reg.variable("device.time").add(t1 - t0)
            reg.variable("device.occTiles").add(result.num_occ_tiles)
            reg.counter(f"readback.mode.{result.readback}").add(1)
            tensors = readback_tensors(result) if read_images else []
            conn.send(("counts", result.counts, result.readback, result.fmt,
                       sum(t.numel() * t.element_size() for t in tensors)))
            del result
            if conn.recv()[0] != "read":
                return
            with reg.timer("readback.copy"):
                hosts = [_shared(t) for t in tensors]
            del tensors
            conn.send(("done", hosts, _stat_delta(reg), t0, t1,
                       mls_cuda.launches - launched))
            del hosts
            done += 1
            if done % _TRIM_EVERY == 0:
                misc.malloc_trim()
    except (EOFError, BrokenPipeError, ConnectionResetError):
        return  # the parent has gone
    except BaseException as e:
        try:
            conn.send(("error", _portable(e), traceback.format_exc()))
        except (OSError, ValueError):
            pass


class WorkerProcess:
    """The parent's end of one worker process (module docstring)."""

    def __init__(self, name: str, device: torch.device, step: Callable,
                 step_args: Dict, threads: int, read_images: bool):
        ctx = torch.multiprocessing.get_context("spawn")
        self.name = name
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(
            target=_worker_main, name=name, daemon=True,
            args=(child, name, device, step, step_args, threads,
                  read_images))
        self.started = time.monotonic()
        try:
            self.proc.start()
        finally:
            child.close()
        get_registry().counter("workers.spawned").add(1)

    def wait_ready(self, cancel) -> bool:
        """Wait for the process to report ready; records the seconds from
        its spawn to ready as workers.startTime, of which those until its
        interpreter had imported the worker's modules as
        workers.importTime. False when the run was cancelled."""
        msg = self.recv(cancel)
        if msg is None:
            return False
        _, entered, ready = msg
        stats = get_registry()
        stats.variable("workers.importTime").add(entered - self.started)
        stats.variable("workers.startTime").add(ready - self.started)
        return True

    def send(self, *msg) -> None:
        self.conn.send(msg)

    def send_block(self, splats, valid, points, region: Sequence[int],
                   origin: Sequence[int]) -> None:
        self.send("block", _shared(splats), _shared(valid),
                  None if points is None or not len(points)
                  else _shared(points),
                  tuple(int(v) for v in region),
                  tuple(int(v) for v in origin))

    def recv(self, cancel) -> Optional[tuple]:
        """The process's next message; None once `cancel` is set. Raises
        the process's exception, or WorkerDied when it has ended."""
        while True:
            ready = connection.wait([self.conn, self.proc.sentinel], 0.2)
            if self.conn in ready:
                try:
                    msg = self.conn.recv()
                except (EOFError, OSError):
                    msg = None
                if msg is not None and msg[0] == "error":
                    _, exc, tb = msg
                    exc.add_note(f"raised in worker process {self.name} "
                                 f"(pid {self.proc.pid}):\n{tb}")
                    raise exc
                if msg is not None:
                    return msg
            if ready:
                self.proc.join(STOP_S)
                raise WorkerDied(self._ended())
            if cancel.is_set():
                return None

    def _ended(self) -> str:
        code = self.proc.exitcode
        why = ""
        if code is not None and code < 0:
            why = f" ({signal.Signals(-code).name})"
        return (f"worker process {self.name} (pid {self.proc.pid}) exited "
                f"with code {code}{why}")

    def stop(self) -> None:
        """Ask the process to exit; terminate, then kill it if it does
        not. Returns once it has ended."""
        try:
            self.conn.send(("stop",))
        except (OSError, ValueError):
            pass
        for end in (None, self.proc.terminate, self.proc.kill):
            if end is not None:
                end()
            self.proc.join(STOP_S)
            if not self.proc.is_alive():
                break
        self.conn.close()


def _enter_group() -> None:
    global _groups, _own_tracker
    with _groups_lock:
        if _groups == 0:
            _own_tracker = resource_tracker._resource_tracker._fd is None
        _groups += 1


def _leave_group(procs: List[WorkerProcess]) -> None:
    """Stop the resource tracker when the last group has left, if the
    groups launched it and none of their processes still holds it open."""
    global _groups
    with _groups_lock:
        _groups -= 1
        if _groups == 0 and _own_tracker and \
                not any(p.proc.is_alive() for p in procs):
            resource_tracker._resource_tracker._stop()


def start_workers(workers, step: Callable, step_args: Dict,
                  read_images: bool) -> List[WorkerProcess]:
    """One WorkerProcess per (device, position, queue) of `workers`, each
    with an equal share of this process's intra-op threads. The caller
    ends them with stop_workers."""
    threads = max(1, torch.get_num_threads() // max(1, len(workers)))
    procs: List[WorkerProcess] = []
    _enter_group()
    try:
        for dev, pos, q in workers:
            procs.append(WorkerProcess(f"device.{pos}.{q}", dev, step,
                                       step_args, threads, read_images))
    except BaseException:
        for p in procs:
            p.stop()
        _leave_group(procs)
        raise
    return procs


def stop_workers(procs: Optional[List[WorkerProcess]]) -> None:
    """Stop every process of a group from start_workers (None or an empty
    list: no group, nothing to do)."""
    if procs:
        for p in procs:
            p.stop()
        _leave_group(procs)
