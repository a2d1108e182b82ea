"""Named statistics registry: counters, mean/stddev variables, peaks, timers.

Re-creation of the reference's observability core (src/statistics.h:130-424):
every queue, buffer, kernel and phase registers named statistics which are
dumped at exit and mergeable across hosts (the MPI Registry::merge analogue).
Thread-safe; serializable to plain dicts for cross-host merging.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterator


class Statistic:
    """Base class for a named statistic."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def merge(self, other: "Statistic") -> None:
        raise NotImplementedError

    def to_dict(self) -> dict:
        raise NotImplementedError

    def load_dict(self, d: dict) -> None:
        raise NotImplementedError

    def __str__(self) -> str:  # pragma: no cover - formatting
        return f"{self.name}: {self.to_dict()}"


class Counter(Statistic):
    """Monotonic event counter (reference Statistics::Counter)."""

    def __init__(self, name: str):
        super().__init__(name)
        self.total = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.total += n

    def get(self) -> int:
        return self.total

    def merge(self, other: "Counter") -> None:
        with self._lock:
            self.total += other.total

    def to_dict(self) -> dict:
        return {"type": "counter", "total": self.total}

    def load_dict(self, d: dict) -> None:
        self.total = d["total"]

    def __str__(self) -> str:
        return f"{self.name}: {self.total}"


class Variable(Statistic):
    """Sampled variable tracking n/mean/stddev (reference Statistics::Variable).

    Stores sum and sum-of-squares so that merge() is associative.
    """

    def __init__(self, name: str):
        super().__init__(name)
        self.n = 0
        self.sum = 0.0
        self.sum2 = 0.0

    def add(self, value: float) -> None:
        with self._lock:
            self.n += 1
            self.sum += value
            self.sum2 += value * value

    def get_mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def get_stddev(self) -> float:
        if self.n < 2:
            return 0.0
        var = (self.sum2 - self.sum * self.sum / self.n) / (self.n - 1)
        return math.sqrt(max(var, 0.0))

    def merge(self, other: "Variable") -> None:
        with self._lock:
            self.n += other.n
            self.sum += other.sum
            self.sum2 += other.sum2

    def to_dict(self) -> dict:
        return {"type": "variable", "n": self.n, "sum": self.sum, "sum2": self.sum2}

    def load_dict(self, d: dict) -> None:
        self.n, self.sum, self.sum2 = d["n"], d["sum"], d["sum2"]

    def __str__(self) -> str:
        return (f"{self.name}: {self.sum} : {self.get_mean()} "
                f"+/- {self.get_stddev()} [{self.n}]")


class Peak(Statistic):
    """Tracks a current value and its high-water mark (reference Statistics::Peak).

    Used for memory accounting: allocate() / free() move the current value.
    """

    def __init__(self, name: str):
        super().__init__(name)
        self.current = 0
        self.peak = 0

    def add(self, delta: int) -> None:
        with self._lock:
            self.current += delta
            if self.current > self.peak:
                self.peak = self.current

    def sub(self, delta: int) -> None:
        self.add(-delta)

    def set(self, value: int) -> None:
        with self._lock:
            self.current = value
            if value > self.peak:
                self.peak = value

    def get(self) -> int:
        return self.current

    def get_max(self) -> int:
        return self.peak

    def merge(self, other: "Peak") -> None:
        # Cross-host peaks are summed pessimistically (hosts peak independently).
        with self._lock:
            self.current += other.current
            self.peak += other.peak

    def to_dict(self) -> dict:
        return {"type": "peak", "current": self.current, "peak": self.peak}

    def load_dict(self, d: dict) -> None:
        self.current, self.peak = d["current"], d["peak"]

    def __str__(self) -> str:
        # parsed by tools/analyze_stats.py
        return f"{self.name}: {self.current} (peak {self.peak})"


class TimerStat(Variable):
    """A Variable of elapsed seconds, usable as a context manager
    (reference Statistics::Timer).

    Instances are shared via the registry, so the in-flight start times are
    kept on a per-thread stack: two threads (or nested uses on one thread)
    timing the same named stat do not corrupt each other.
    """

    def __init__(self, name: str):
        super().__init__(name)
        self._local = threading.local()

    def __enter__(self) -> "TimerStat":
        stack = getattr(self._local, "starts", None)
        if stack is None:
            stack = self._local.starts = []
        stack.append(time.monotonic())
        return self

    def __exit__(self, *exc) -> None:
        self.add(time.monotonic() - self._local.starts.pop())


_TYPES = {"counter": Counter, "variable": Variable, "peak": Peak}


class Registry:
    """Thread-safe named statistic registry (reference Statistics::Registry,
    src/statistics.h:330-424). getStatistic-style accessors create on demand."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Statistic] = {}

    def _get(self, name: str, cls) -> Statistic:
        with self._lock:
            stat = self._stats.get(name)
            if stat is None:
                stat = cls(name)
                self._stats[name] = stat
            elif not isinstance(stat, cls):
                raise TypeError(f"statistic {name} is {type(stat).__name__}, wanted {cls.__name__}")
            return stat

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def variable(self, name: str) -> Variable:
        return self._get(name, Variable)

    def peak(self, name: str) -> Peak:
        return self._get(name, Peak)

    def timer(self, name: str) -> TimerStat:
        return self._get(name, TimerStat)

    def __iter__(self) -> Iterator[Statistic]:
        with self._lock:
            return iter(sorted(self._stats.values(), key=lambda s: s.name))

    def merge(self, other: "Registry") -> None:
        """Merge another registry into this one (the MPI statistics-gather
        analogue, mlsgpu-mpi.cpp:302-339)."""
        for stat in other:
            mine = self._get(stat.name, type(stat))
            mine.merge(stat)

    def to_dict(self) -> dict:
        return {s.name: s.to_dict() for s in self}

    def load_dict(self, d: dict) -> None:
        for name, sd in d.items():
            stat = self._get(name, _TYPES[sd["type"]])
            stat.load_dict(sd)

    def dump(self, file=None) -> None:
        import sys
        file = file or sys.stdout
        for stat in self:
            print(str(stat), file=file)

    def clear(self) -> None:
        """Drop all statistics (e.g. between a warm-up and a measured run,
        so a dump reflects only the measured work)."""
        with self._lock:
            self._stats.clear()


_registry = Registry()


def get_registry() -> Registry:
    """The process-wide singleton registry (Statistics::Registry::getInstance)."""
    return _registry


def set_registry(registry: Registry) -> Registry:
    """Swap the process-wide registry and return the previous one. Used by
    profiling sub-runs (e.g. bench.py's device-stage sample) that must not
    pollute the measured run's statistics."""
    global _registry
    old = _registry
    _registry = registry
    return old
