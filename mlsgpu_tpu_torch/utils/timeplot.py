"""Per-worker action tracing to a text file.

Re-creation of the reference timeplot subsystem (src/timeplot.h:37-120): each
Worker owns a LIFO stack of Actions; entering a nested action pauses the outer
one; lines of the form `EVENT <worker> <action> <start> <stop>` (a worker's
running intervals, its children's cut out) are compatible with the
reference's utils/timeplot.py analyzers.

While a file is open (`init(path)`), finished intervals are kept in memory
and written when the file is closed (`init(None)` or the next `init`), so an
action does no I/O and takes no lock. With no file open an action keeps
nothing: it only adds to its statistics.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, TextIO, Tuple

_lock = threading.Lock()
_file: Optional[TextIO] = None
#: The open file's finished intervals (worker, action, start, stop); None
#: while no file is open.
_spans: Optional[List[Tuple[str, str, float, float]]] = None


def init(path: Optional[str]) -> None:
    """Open the timeplot output file (--timeplot FILE); None disables. The
    file open before, if any, gets its intervals and is closed."""
    global _file, _spans
    with _lock:
        old, spans = _file, _spans
        _file = _spans = None
        if old is not None:
            with old:
                old.writelines(f"EVENT {w} {a} {lo!r} {hi!r}\n"
                               for w, a, lo, hi in spans)
        if path:
            _file, _spans = open(path, "w"), []


def record(worker: str, action: str, start: float, stop: float) -> None:
    """Keep one finished interval of `worker` timed elsewhere, for example
    in a worker process (time.monotonic is one clock for all processes of
    the machine)."""
    spans = _spans
    if spans is not None:
        spans.append((worker, action, start, stop))


class Worker:
    """A traced worker (usually one per thread). Mirrors Timeplot::Worker."""

    def __init__(self, name: str, idx: Optional[int] = None):
        self.name = f"{name}.{idx}" if idx is not None else name
        self._stack: list["Action"] = []


class Action:
    """A timed action on a worker's LIFO stack (Timeplot::Action).

    Usable as a context manager; nested actions pause the parent so the
    recorded intervals never overlap within one worker. On exit `stat`
    gets the action's wall time and `cpu_stat` its thread's CPU time
    (time.thread_time), both from enter to exit, children included.
    """

    def __init__(self, name: str, worker: Worker, stat=None, cpu_stat=None):
        self.name = name
        self.worker = worker
        self.stat = stat
        self.cpu_stat = cpu_stat
        self._entered = 0.0
        self._cpu = 0.0
        self._running_since = 0.0

    def _pause(self, now: float) -> None:
        record(self.worker.name, self.name, self._running_since, now)

    def __enter__(self) -> "Action":
        stack = self.worker._stack
        now = time.monotonic()
        if stack:
            stack[-1]._pause(now)
        stack.append(self)
        self._entered = self._running_since = now
        self._cpu = time.thread_time()   # inside the wall interval
        return self

    def __exit__(self, *exc) -> None:
        cpu = time.thread_time() - self._cpu
        now = time.monotonic()
        self._pause(now)
        stack = self.worker._stack
        assert stack and stack[-1] is self
        stack.pop()
        if stack:
            stack[-1]._running_since = now
        if self.stat is not None:
            self.stat.add(now - self._entered)
        if self.cpu_stat is not None:
            self.cpu_stat.add(cpu)
