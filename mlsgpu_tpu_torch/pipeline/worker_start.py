"""How worker processes start (pipeline/workers.py), and the first code
each of them runs.

Worker processes are forked from one server, multiprocessing's
forkserver, which has imported torch and the block step's modules once
(pipeline/worker_preload.py): a run of N workers pays that import once,
not once per process, and a forked worker then pays its CUDA context and
the kernel library alone. The server never touches CUDA, so no worker
inherits CUDA state; each sets its own card. The server starts when a run
first holds it (`hold_server`), as early as the run knows that it will
have more than one worker (cli.py does so before it imports torch itself,
so that the server's import overlaps the parent's own, the blob pass and
bucketing), and stops, with Python's resource tracker that it starts,
when the last holder lets go (`release_server`), so that no process of a
run outlives it. A server or a worker that cannot start is an error that
names it: workers never start another way.

This module imports the standard library alone: cli.py imports it before
torch, and a worker reaches `boot` before anything else of the port.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import re
import sys
import threading
import time
from multiprocessing import forkserver, resource_tracker
from typing import Optional

from mlsgpu_tpu_torch.utils.errors import MlsError

#: What the server imports before it forks a worker. Not the parent's
#: main module: multiprocessing does not pass the server a script's path
#: to preload, so each forked process re-imports a script main itself, as
#: a spawned one does (a `python -m` package's __main__ none re-imports).
PRELOAD = ["mlsgpu_tpu_torch.pipeline.worker_preload"]

_lock = threading.Lock()
_holders = 0
_own_server = False
_own_tracker = False
_stuck = False
#: When the running server was launched (monotonic clock), else None.
launched: Optional[float] = None


def context():
    """The multiprocessing context that worker processes start with."""
    return multiprocessing.get_context("forkserver")


def several_workers(cfg, device: str) -> bool:
    """Whether a run of `cfg` on `device` (--device) will have more than
    one worker, as far as its options and the machine tell before torch
    is imported: --device-threads or --num-devices above 1, or `cuda`
    (every card) with more than one card to see (cards_seen). A wrong
    guess costs time, not correctness: a needless server imports torch
    beside the run's own import, and a missed one starts when the run
    needs it (workers.start_workers)."""
    if int(cfg.device_threads) > 1 or int(cfg.num_devices) > 1:
        return True
    return device == "cuda" and not cfg.num_devices and cards_seen() > 1


def cards_seen() -> int:
    """The cards this process will see, as far as the environment tells
    without CUDA: the entries of CUDA_VISIBLE_DEVICES when it is set, else
    of the container runtime's NVIDIA_VISIBLE_DEVICES when that lists
    cards; 0 when neither tells ("all", or unset). Not the /dev/nvidia<N>
    files: a container of one card may hold several."""
    for var in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES"):
        env = os.environ.get(var)
        if env is None:
            continue
        cards = [d for d in env.split(",") if d.strip()]
        if var == "NVIDIA_VISIBLE_DEVICES" and \
                not all(re.fullmatch(r"\d+|GPU-[-0-9a-fA-F]+", d.strip())
                        for d in cards):
            return 0              # all, none, void: no count
        return len(cards)
    return 0


def hold_server() -> None:
    """Start the server unless it runs, and hold it until
    `release_server`. Does not wait for its imports."""
    global _holders, _own_server, _own_tracker, launched
    with _lock:
        if _holders == 0:
            _own_tracker = resource_tracker._resource_tracker._fd is None
            _own_server = forkserver._forkserver._forkserver_pid is None
            context().set_forkserver_preload(PRELOAD)
            launched = time.monotonic()
            try:
                forkserver.ensure_running()
            except Exception as e:
                launched = None
                raise MlsError(f"the worker server could not start: "
                               f"{type(e).__name__}: {e}") from e
        _holders += 1


def release_server(workers_alive: bool = False) -> None:
    """Let go of the server. The last holder stops it and the resource
    tracker, if holding them launched them; not while a worker process
    may still run (`workers_alive`): it holds both their pipes open, and
    stopping them waits for their end."""
    global _holders, _stuck, launched
    with _lock:
        _holders -= 1
        _stuck = _stuck or workers_alive
        if _holders or _stuck:
            return
        if _own_server:
            forkserver._forkserver._stop()
            launched = None
        if _own_tracker:
            resource_tracker._resource_tracker._stop()


def boot(conn, payload: bytes) -> None:
    """A worker process's target. `payload` is the pickled tuple of
    workers._worker_main's arguments after `conn` and the marks. A worker
    forked from the server finds worker_preload imported there, with the
    server's marks."""
    from mlsgpu_tpu_torch.pipeline import worker_preload
    marks = dict(worker_preload.MARKS)
    args = pickle.loads(payload)
    marks["entered"] = time.monotonic()
    # multiprocessing has re-imported a script's main module here under
    # the name __mp_main__ (a package's __main__ it skips)
    marks["main"] = sys.modules["__main__"].__name__ == "__mp_main__"
    from mlsgpu_tpu_torch.pipeline.workers import _worker_main
    _worker_main(conn, marks, *args)
