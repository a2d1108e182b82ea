"""Launch counts of the port's hand-written kernels, by kernel name.

Each wrapper calls `count(name)` where it launches its kernel and nowhere
else (ops/mls_cuda.py, ops/seam_cuda.py, ops/binning_cuda.py,
ops/marching_cuda.py, ops/mesh_cuda.py). A worker process sends back what
it counted for a block (`since`), and the parent `add`s it
(pipeline/workers.py). `reset` before a run counts that run's launches
alone.
"""

from __future__ import annotations

import threading
from typing import Dict, Mapping

#: Every hand-written kernel, by the name its wrapper counts it under, and
#: the statistic a run records its launches as (pipeline/streamer.py).
KERNELS = {
    "mls_field": "mls.launches",
    "seam_face": "seam.faceLaunches",
    "seam_skeleton": "seam.skeletonLaunches",
    "bin_keys": "binning.keyLaunches",
    "bin_sort_histogram": "binning.sortHistogramLaunches",
    "bin_sort_pass": "binning.sortPassLaunches",
    "bin_entries": "binning.entryLaunches",
    "tile_bounds": "binning.boundLaunches",
    "tile_segments": "binning.segmentLaunches",
    "march_classify": "marching.classifyLaunches",
    "march_scan": "marching.scanLaunches",
    "march_emit": "marching.emitLaunches",
    "march_emit_mesh": "marching.emitMeshLaunches",
    "weld_sort_histogram": "weld.sortHistogramLaunches",
    "weld_sort_pass": "weld.sortPassLaunches",
    "weld_group": "weld.groupLaunches",
    "pack_readback": "pack.launches",
}

_counts = dict.fromkeys(KERNELS, 0)
_lock = threading.Lock()


def count(name: str) -> None:
    """One launch of kernel `name` (a key of KERNELS)."""
    if name not in KERNELS:
        raise KeyError(f"no kernel named {name!r}")
    with _lock:
        _counts[name] += 1


def counts() -> Dict[str, int]:
    """This process's launches of every kernel, by name."""
    with _lock:
        return dict(_counts)


def since(before: Mapping[str, int]) -> Dict[str, int]:
    """The launches of every kernel since `before` (an earlier counts())."""
    now = counts()
    return {k: now[k] - before[k] for k in KERNELS}


def add(delta: Mapping[str, int]) -> None:
    """Add launches counted elsewhere (a worker process's `since`)."""
    if not set(delta) <= set(KERNELS):
        raise KeyError(f"no kernels named {sorted(set(delta) - set(KERNELS))}")
    with _lock:
        for k, n in delta.items():
            _counts[k] += int(n)


def reset() -> None:
    """Every kernel's count to 0."""
    with _lock:
        for k in KERNELS:
            _counts[k] = 0
