"""OS disk I/O counters for statistics output (reference src/diskstats.{h,cpp}
reads the same /proc counters to attribute real disk traffic to a run)."""

from __future__ import annotations

from typing import Dict, Optional

_FIELDS = ("reads", "read_sectors", "writes", "write_sectors")


def snapshot() -> Dict[str, int]:
    """Aggregate read/write counters over all physical block devices.
    Sectors are 512 bytes. Returns zeros when /proc/diskstats is missing."""
    totals = dict.fromkeys(_FIELDS, 0)
    try:
        with open("/proc/diskstats") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 14:
                    continue
                name = parts[2]
                # skip partitions and virtual devices
                if name.startswith(("loop", "ram", "dm-")) or name[-1].isdigit():
                    continue
                totals["reads"] += int(parts[3])
                totals["read_sectors"] += int(parts[5])
                totals["writes"] += int(parts[7])
                totals["write_sectors"] += int(parts[9])
    except OSError:
        pass
    return totals


class DiskUsage:
    """Context manager recording byte deltas into the statistics registry."""

    def __init__(self, registry=None, prefix: str = "disk"):
        from mlsgpu_tpu_torch.utils.statistics import get_registry
        self._registry = registry or get_registry()
        self._prefix = prefix
        self._start: Optional[Dict[str, int]] = None

    def __enter__(self) -> "DiskUsage":
        self._start = snapshot()
        return self

    def __exit__(self, *exc) -> None:
        end = snapshot()
        delta = {k: end[k] - self._start[k] for k in _FIELDS}
        self._registry.counter(f"{self._prefix}.readBytes").add(
            delta["read_sectors"] * 512)
        self._registry.counter(f"{self._prefix}.writeBytes").add(
            delta["write_sectors"] * 512)
        self._registry.counter(f"{self._prefix}.reads").add(delta["reads"])
        self._registry.counter(f"{self._prefix}.writes").add(delta["writes"])
