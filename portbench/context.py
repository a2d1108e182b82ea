"""What a metric's reader gets: the readings of one run's window.

A reader (portbench/metrics/<name>.py) is `read(ctx) -> float or None`. It
returns None where the run has nothing for it to read (a trace metric in a
run without a trace, a statistic the program did not record), and the
harness then leaves the metric out of the result.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from portbench.trace import TraceSummary


@dataclass
class MetricContext:
    jobs: int                     # jobs finished in the window
    splats: int                   # splats of one job's cloud
    window_s: float               # first job's start to last job's end
    setup_s: float                # process start to the window's start
    peak_rss_bytes: int           # summed RSS of the run's processes
    sink_bytes: int               # the output buffers' bytes, resident
    field_bytes: int              # one dispatch's dense field, f32
    stats: Dict[str, Dict] = field(default_factory=dict)
    trace: Optional[TraceSummary] = None
    traced_launches: Dict[str, int] = field(default_factory=dict)

    def total(self, name: str) -> Optional[float]:
        """A timer's or variable's sum, a counter's total; None if the
        window did not record it."""
        d = self.stats.get(name)
        if d is None:
            return None
        return float(d["total"] if d["type"] == "counter" else d["sum"])

    def peak(self, name: str) -> Optional[float]:
        d = self.stats.get(name)
        return None if d is None else float(d["peak"])

    @property
    def blocks(self) -> Optional[float]:
        """Blocks the window's jobs ran (bucketing's count)."""
        n = self.total("bucket.count")
        return n if n else None

    def per_job_ms(self, name: str) -> Optional[float]:
        v = self.total(name)
        return None if v is None or not self.jobs else 1e3 * v / self.jobs

    def per_block_ms(self, name: str) -> Optional[float]:
        v, n = self.total(name), self.blocks
        return None if v is None or not n else 1e3 * v / n
