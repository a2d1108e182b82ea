"""The host's resident set of the run's process, sampled through the
window.

The run's process is the only one a measured cell has: its workers are
threads (portbench/harness.py refuses a cell of worker processes). The
sampler reads /proc/self/statm, one short read, every 50 ms on a thread
of its own, so it holds the interpreter's lock for a few microseconds a
sample. The card's machine runs a sandboxed kernel whose /proc has no
smaps_rollup and reports no shared pages in statm, so the proportional
set size cannot be had there: the resident set counts the pages of
shared libraries whole.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

PAGE = os.sysconf("SC_PAGE_SIZE")


def rss_bytes() -> int:
    """This process's resident bytes."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE


class RssSampler:
    """The peak resident set of this process, sampled every `interval`
    seconds on a thread from `start` to `stop`."""

    def __init__(self, interval: float = 0.05):
        self.interval = interval
        self.peak = 0
        self.samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample(self) -> int:
        total = rss_bytes()
        self.peak = max(self.peak, total)
        self.samples += 1
        return total

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.sample()

    def start(self) -> None:
        self.sample()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="portbench-rss")
        self._thread.start()

    def stop(self) -> int:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.sample()
        return self.peak
