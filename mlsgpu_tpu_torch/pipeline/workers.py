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

    parent -> ("block", world-frame splats, grid, skeleton points,
               region, origin)
    child  -> ("counts", counts, readback mode, fmt, image bytes)
    parent -> ("read",)       once --mem-mesh admits the image
    child  -> ("done", host images, statistics, start, end, launches of
               the field, face and skeleton kernels)

Tensors in these messages travel through shared memory (torch's file
descriptor sharing), not through the pipe. The parent's loader reads a
bucket once, straight into a shared tensor, which goes as it is; the
child converts it to the grid frame itself (core.splat.block_inputs: the
same numpy code on the same bytes as the loader's for a worker thread, so
the same bits), which leaves the parent's one interpreter the read alone.
The child copies its readback images from the device into fresh shared
tensors, which the parent hands to the mesher as they are. ("stop",) ends
a process at any point; a child that fails sends ("error", exception,
traceback) and exits.

A process is forked from the worker server (pipeline/worker_start.py),
which imported torch and the block step's modules once for all of them
and never touched CUDA. Each process sets its card (creating its CUDA
context), FP32 precision and a small intra-op thread count, and loads the
MLS kernel library before it reports ready. A process that cannot start,
or that raises or dies later, ends the run: no block is ever run in the
parent or on the CPU in its place. `start_workers` asks the server for a
group's processes from a thread of its own, so that a run goes on with
its blob pass while the server imports; `stop_workers` ends them and lets
go of the server, which stops, with Python's resource tracker, when no
group or run holds it, so that no process of a run outlives it.

A start is recorded as: workers.upTime, workers.torchTime and
workers.moduleTime, the server's own start (launch to interpreter up,
torch's import, the block step's modules), once per server; per process
workers.importTime (from the request to the process running with those
modules: any wait for the server's imports, the fork, and the re-import
of a script's main module, which workers.mainImported counts),
workers.cudaTime (the CUDA context), workers.kernelTime (the kernel
library) and workers.startTime (request to ready).
"""

from __future__ import annotations

import pickle
import signal
import threading
import time
import traceback
from multiprocessing import connection
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.multiprocessing  # noqa: F401 (tensors through shared memory)

from mlsgpu_tpu_torch.core.splat import block_inputs
from mlsgpu_tpu_torch.device import set_precision
from mlsgpu_tpu_torch.ops import mls_cuda, seam_cuda
from mlsgpu_tpu_torch.ops.block import readback_tensors
from mlsgpu_tpu_torch.pipeline import worker_start
from mlsgpu_tpu_torch.utils import misc, step_profile
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

# The server launch whose own start record_start has recorded.
_recorded_lock = threading.Lock()
_server_recorded: Optional[float] = None


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


def record_start(started: float, marks: Dict) -> None:
    """Record a worker process's start (module docstring) from its clock
    marks (worker_start.boot, _worker_main) and `started`, when this
    process asked the server for it. The server's own start, which every
    worker of one server shares, is recorded once per server."""
    global _server_recorded
    stats = get_registry()
    launched = worker_start.launched
    with _recorded_lock:
        first = launched is not None and _server_recorded != launched
        if first:
            _server_recorded = launched
    if first:
        stats.variable("workers.upTime").add(marks["up"] - launched)
        stats.variable("workers.torchTime").add(marks["torch"]
                                                - marks["up"])
        stats.variable("workers.moduleTime").add(marks["modules"]
                                                 - marks["torch"])
    stats.counter("workers.mainImported").add(int(marks["main"]))
    if "cuda" in marks:
        stats.variable("workers.cudaTime").add(marks["cuda"]
                                               - marks["entered"])
        stats.variable("workers.kernelTime").add(marks["kernel"]
                                                 - marks["cuda"])
    stats.variable("workers.importTime").add(marks["entered"] - started)
    stats.variable("workers.startTime").add(marks["ready"] - started)


def _worker_main(conn, marks: Dict, name: str, device: torch.device,
                 step: Callable, step_args: Dict, threads: int,
                 read_images: bool) -> None:
    """A worker process (entered from worker_start.boot, whose clock marks
    `marks` are): set up, report ready, then run blocks until told to stop
    or until the parent's end of the pipe closes."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # the parent stops us
    profiler = step_profile.StepProfiler(name)
    try:
        torch.set_num_threads(threads)
        misc.bound_mmap_threshold()
        if device.type == "cuda":
            torch.cuda.set_device(device)   # creates the CUDA context
            marks["cuda"] = time.monotonic()
            mls_cuda.load()
            marks["kernel"] = time.monotonic()
        set_precision()
        marks["ready"] = time.monotonic()
        conn.send(("ready", marks))
        done = 0
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                return
            _, raw, grid, points, region, origin = msg
            del msg
            reg = Registry()
            set_registry(reg)
            launched = seam_cuda.launch_counts()
            with reg.timer("workers.convert"):
                splats, valid = block_inputs(raw.numpy(), grid)
            del raw
            t0 = time.monotonic()
            sp, va, pts = to_device(device, splats, valid, points)
            del splats, valid, points
            with profiler.step():
                result = step(sp, va, region, origin, points=pts,
                              **step_args)
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
                       [b - a for a, b in zip(launched,
                                              seam_cuda.launch_counts())]))
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
    finally:
        profiler.close()


class WorkerProcess:
    """The parent's end of one worker process (module docstring)."""

    def __init__(self, name: str, device: torch.device, step: Callable,
                 step_args: Dict, threads: int, read_images: bool):
        ctx = worker_start.context()
        self.name = name
        self.conn, self._child = ctx.Pipe()
        self.proc = ctx.Process(
            target=worker_start.boot, name=name, daemon=True,
            args=(self._child, pickle.dumps((name, device, step, step_args,
                                             threads, read_images))))
        self.started: Optional[float] = None
        self.start_error: Optional[BaseException] = None
        self._starting: Optional[threading.Thread] = None

    def start(self) -> None:
        """Ask the server for the process. Waits while the server is still
        importing; an error is kept for wait_ready to raise."""
        self.started = time.monotonic()
        try:
            self.proc.start()
            get_registry().counter("workers.spawned").add(1)
        except Exception as e:
            self.start_error = e
        finally:
            self._child.close()

    def _started(self, cancel=None) -> bool:
        """Wait until start() has returned (False once `cancel` is set);
        raise its error, naming the process."""
        while self._starting is not None and self._starting.is_alive():
            self._starting.join(0.2)
            if cancel is not None and cancel.is_set():
                return False
        if self.start_error is not None:
            raise MlsError(f"worker process {self.name} could not start: "
                           f"{type(self.start_error).__name__}: "
                           f"{self.start_error}") from self.start_error
        return True

    def wait_ready(self, cancel) -> bool:
        """Wait for the process to report ready and record its start
        (module docstring). False when the run was cancelled."""
        if not self._started(cancel):
            return False
        msg = self.recv(cancel)
        if msg is None:
            return False
        record_start(self.started, msg[1])
        return True

    def send(self, *msg) -> None:
        self.conn.send(msg)

    def send_block(self, splats, grid, points, region: Sequence[int],
                   origin: Sequence[int]) -> None:
        """Hand a block to the process: its world-frame splats (a shared
        tensor goes as it is, anything else is copied into one), the grid
        that frames them, its skeleton points."""
        with get_registry().timer("workers.sendCopy"):
            if not (isinstance(splats, torch.Tensor) and splats.is_shared()):
                splats = _shared(splats)
            points = (None if points is None or not len(points)
                      else _shared(points))
        self.send("block", splats, grid, points,
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
        if self._starting is not None:
            self._starting.join()
        if self.proc.pid is None:     # never started
            self._child.close()
            self.conn.close()
            return
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


def start_workers(workers, step: Callable, step_args: Dict,
                  read_images: bool) -> List[WorkerProcess]:
    """One WorkerProcess per (device, position, queue) of `workers`, each
    with an equal share of this process's intra-op threads, forked from
    the server (worker_start) by a thread of their own, so that this
    returns without waiting for the server's imports. The caller waits
    for each with wait_ready and ends them with stop_workers."""
    threads = max(1, torch.get_num_threads() // max(1, len(workers)))
    worker_start.hold_server()
    procs: List[WorkerProcess] = []
    try:
        for dev, pos, q in workers:
            procs.append(WorkerProcess(f"device.{pos}.{q}", dev, step,
                                       step_args, threads, read_images))
    except BaseException:
        for p in procs:
            p.stop()
        worker_start.release_server()
        raise
    starting = threading.Thread(target=lambda: [p.start() for p in procs],
                                name="worker-start", daemon=True)
    for p in procs:
        p._starting = starting
    starting.start()
    return procs


def stop_workers(procs: Optional[List[WorkerProcess]]) -> None:
    """Stop every process of a group from start_workers (None or an empty
    list: no group, nothing to do), and let go of the server."""
    if procs:
        for p in procs:
            p.stop()
        worker_start.release_server(
            workers_alive=any(p.proc.is_alive() for p in procs
                              if p.proc.pid is not None))
