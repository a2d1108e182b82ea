"""Per-worker action tracing to a text file.

Re-creation of the reference timeplot subsystem (src/timeplot.h:37-120): each
Worker owns a LIFO stack of Actions; entering a nested action pauses the outer
one; lines of the form `EVENT <worker> <action> <start> <stop>` are written on
completion, compatible with the reference's utils/timeplot.py analyzers.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, TextIO

_lock = threading.Lock()
_file: Optional[TextIO] = None


def init(path: Optional[str]) -> None:
    """Open the timeplot output file (--timeplot FILE); None disables."""
    global _file
    with _lock:
        if _file is not None:
            _file.close()
            _file = None
        if path:
            _file = open(path, "w")


def _write(line: str) -> None:
    with _lock:
        if _file is not None:
            _file.write(line + "\n")


def record(worker: str, action: str, start: float, stop: float) -> None:
    """Write one finished action of `worker` timed elsewhere, for example
    in a worker process (time.monotonic is one clock for all processes of
    the machine)."""
    _write(f"EVENT {worker} {action} {start!r} {stop!r}")


class Worker:
    """A traced worker (usually one per thread). Mirrors Timeplot::Worker."""

    def __init__(self, name: str, idx: Optional[int] = None):
        self.name = f"{name}.{idx}" if idx is not None else name
        self._stack: list["Action"] = []


class Action:
    """A timed action on a worker's LIFO stack (Timeplot::Action).

    Usable as a context manager; nested actions pause the parent so the
    reported intervals never overlap within one worker. An optional statistic
    (Variable of seconds) and value-statistic receive the totals.
    """

    def __init__(self, name: str, worker: Worker, stat=None, value_stat=None, value: float = 0.0):
        self.name = name
        self.worker = worker
        self.stat = stat
        self.value_stat = value_stat
        self.value = value
        self._elapsed = 0.0
        self._running_since: Optional[float] = None

    def set_value(self, value: float) -> None:
        self.value = value

    def _pause(self) -> None:
        if self._running_since is not None:
            now = time.monotonic()
            self._elapsed += now - self._running_since
            record(self.worker.name, self.name, self._running_since, now)
            self._running_since = None

    def _resume(self) -> None:
        if self._running_since is None:
            self._running_since = time.monotonic()

    def __enter__(self) -> "Action":
        stack = self.worker._stack
        if stack:
            stack[-1]._pause()
        stack.append(self)
        self._resume()
        return self

    def __exit__(self, *exc) -> None:
        self._pause()
        stack = self.worker._stack
        assert stack and stack[-1] is self
        stack.pop()
        if stack:
            stack[-1]._resume()
        if self.stat is not None:
            self.stat.add(self._elapsed)
        if self.value_stat is not None and self.value:
            self.value_stat.add(self.value)


def action(name: str, worker: Worker, stat=None) -> Action:
    """Convenience constructor matching the reference's Timeplot::Action usage."""
    return Action(name, worker, stat=stat)
