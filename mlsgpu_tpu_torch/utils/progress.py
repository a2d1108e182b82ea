"""Thread-safe progress meters (reference src/progress.h:42-109)."""

from __future__ import annotations

import sys
import threading
import time


class ProgressMeter:
    """Abstract progress sink: operator+= in the reference."""

    def add(self, n: int) -> None:
        raise NotImplementedError

    def __iadd__(self, n: int) -> "ProgressMeter":
        self.add(n)
        return self


class NullProgress(ProgressMeter):
    def add(self, n: int) -> None:
        pass


class ProgressCounter(ProgressMeter):
    """Accumulates progress without display (used as a sink in tests and as
    the per-host aggregation point for distributed progress, the ProgressMPI
    analogue src/progress_mpi.h:54-88)."""

    def __init__(self, total: int = 0):
        self.total = total
        self.current = 0
        self._lock = threading.Lock()

    def add(self, n: int) -> None:
        with self._lock:
            self.current += n


class ProgressDisplay(ProgressCounter):
    """ASCII progress bar on a terminal stream (reference ProgressDisplay)."""

    def __init__(self, total: int, stream=None, label: str = "", min_interval: float = 0.2):
        super().__init__(total)
        self.stream = stream if stream is not None else sys.stderr
        self.label = label
        self.min_interval = min_interval
        self._last_draw = 0.0
        self._done = False
        if label:
            print(label, file=self.stream, flush=True)

    def add(self, n: int) -> None:
        with self._lock:
            self.current += n
            now = time.monotonic()
            if now - self._last_draw >= self.min_interval or self.current >= self.total:
                self._draw()
                self._last_draw = now

    def _draw(self) -> None:
        frac = self.current / self.total if self.total else 1.0
        frac = min(max(frac, 0.0), 1.0)
        width = 50
        filled = int(width * frac)
        bar = "*" * filled + "-" * (width - filled)
        end = "\n" if (frac >= 1.0 and not self._done) else "\r"
        if frac >= 1.0:
            self._done = True
        self.stream.write(f"|{bar}| {frac * 100:5.1f}%{end}")
        self.stream.flush()
