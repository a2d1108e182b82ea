"""Device memory precheck (port of mlsgpu_tpu/pipeline/resources.py, the
reference's resourceUsage/validateDevice, src/mlsgpu_core.cpp:469-518):
estimate one block step's device working set from the configuration and
fail early when a card cannot hold it once for each of its queues (and,
with worker processes, a CUDA context for each)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from mlsgpu_tpu_torch.config import ReconstructConfig
from mlsgpu_tpu_torch.utils import logging as log
from mlsgpu_tpu_torch.utils.errors import InvalidOption

from mlsgpu_tpu_torch.ops.marching import TILE, TILED_ABOVE
from mlsgpu_tpu_torch.pipeline.workers import (WORKER_CONTEXT_BYTES,
                                               uses_processes)

F32 = 4
I64 = 8


#: Assumed shares of a dispatch's cells that the surface cuts and of its
#: 8^3 tiles that hold finite corners (the MLS field is finite only near
#: the surface). Both are generous: the 2M bench cloud's output has about
#: 0.01 welded vertices per cell of its 50 blocks of 255^3 cells, and its
#: densest block has MLS candidates in 2,841 of 32,768 tiles (8.7%).
SURFACE_CELL_SHARE = 1 / 32
CANDIDATE_TILE_SHARE = 1 / 4


#: f32 temporaries per corner of the fit over every face patch corner
#: (ops/mls.py::_fit and the sphere fit: the re-centred moments, the fit's
#: intermediates and the dot products' partial sums live at its peak).
FIT_TEMPS = 24

#: Device memory the seam kernels' per-thread local memory takes (a corner
#: thread's list of term entries and its stacks of partial sums,
#: csrc/seam_moments.cu: a 1,648-byte stack frame by nvcc's -Xptxas -v for
#: sm_90a): the driver reserves it for every thread a card can hold, 2048
#: on each of an H100's 132 multiprocessors, in each process that
#: launches them.
SEAM_STACK_BYTES = 1648 * 2048 * 132


def estimate_block_usage(cfg: ReconstructConfig, readback: str = "codes",
                         device_type: str = "cuda") -> Dict[str, int]:
    """Approximate peak device bytes of one block step in a readback mode
    ("codes", "packed" or "raw") on a device of `device_type` ("cuda": the
    kernels' path; "cpu": the plain versions')."""
    b = 1 << cfg.device_shift  # corners of one device dispatch
    cells = (b - 1) ** 3
    n = cfg.max_device_splats
    entries = 8 * n
    rows = 6 * (b // TILE + 1) ** 2  # face patch rows of 64 corners
    usage = {
        "splats": n * (8 * F32 + 1),
        # keys + vals (+ the sort's copies) and the gathered entry rows
        "binning": entries * (2 * I64 * 2 + 8 * F32),
        "field": b ** 3 * F32,
    }
    if device_type == "cuda":
        # the face kernel's moments (9 f32) and hits (i32) of every patch
        # corner, the corners (3 f32) and the fit's temporaries, and the
        # kernels' stacks
        usage["faces"] = (rows * 64 * ((9 + 3 + FIT_TEMPS) * F32 + 4)
                          + SEAM_STACK_BYTES)
    else:
        # per-chunk tensors of the face pass over 32 rows x 64 corners x K
        # slots, K ~ the per-tile candidate guess: the weighted moments
        # (9 f32) and the first level of their pairwise tree, the
        # per-corner sort's order (i64) and key (u8), the weights, their
        # sorted copy and the distance temporaries (4 f32), the reach mask
        # (u8)
        usage["faces"] = 32 * 64 * cfg.tile_candidates * (
            2 * 9 * F32 + I64 + 4 * F32 + 2)
    if b > TILED_ABOVE:
        # tiled classification: the NaN-padded field copy, the candidate
        # tiles' (tiles, 9, 9, 9) halo gather, and per candidate cell a
        # case code and masks
        tiles = int(-(-(b - 1) // TILE) ** 3 * CANDIDATE_TILE_SHARE)
        usage["marching_tiled"] = ((b + TILE) ** 3 * F32
                                   + tiles * (TILE + 1) ** 3 * F32
                                   + tiles * TILE ** 3 * (I64 + 3))
    else:
        # dense classification: case code, finite/region/occupied masks and
        # a shifted-corner temporary per cell
        usage["marching_dense"] = cells * (I64 + 3 + F32)
    # Emission, per occupied cell: code, (x, y, z), 8 corner isos; per
    # emitted vertex (<= 13 per cell, ~4 on a surface) its producer, rank,
    # edge and t.
    occ = int(cells * SURFACE_CELL_SHARE)
    verts = 4 * occ
    usage["emission"] = occ * (4 * I64 + 8 * F32) + verts * (4 * I64 + F32)
    if readback != "codes":
        # mesh mode: f32 vertices, (hi, lo) keys and ~2 triangles of three
        # int64 indices per vertex; the weld's sort key, order, first-mask,
        # new ids and remap; the welded copies (~half the vertices)
        usage["mesh"] = verts * (3 * F32 + 2 * I64 + 2 * 3 * I64)
        usage["weld"] = verts * (4 * I64 + 1) + verts // 2 * (3 * F32
                                                              + 2 * I64)
        if readback == "packed":
            # per welded vertex: doubled coords, parity, base, fractions,
            # word fields; then the u16 byte pairs of both regions
            usage["pack"] = verts // 2 * (6 * I64 + 3 * F32 + 4 * I64)
    usage["total"] = sum(usage.values())
    return usage


def device_memory_bytes(device: torch.device) -> Optional[int]:
    """Total memory of a CUDA device; None for the CPU."""
    if device.type != "cuda":
        return None
    _, total = torch.cuda.mem_get_info(device)
    return int(total)


def validate_device(cfg: ReconstructConfig,
                    devices: Sequence[torch.device], readback: str,
                    queues: int = 1) -> Dict[str, int]:
    """Estimate one block step in the resolved readback mode and check it
    against every device used: `queues` workers run on each entry of
    `devices` (an entry per use of a device), and each worker holds one
    block step's working set at a time. When the run has more than one
    worker, each is a process (pipeline/workers.py) and also holds its own
    CUDA context on its card (WORKER_CONTEXT_BYTES). Raises InvalidOption
    when a card cannot hold its workers."""
    devices = list(devices)
    queues = max(1, int(queues))
    processes = uses_processes(len(devices) * queues)
    usage = {}
    for dev in sorted(set(devices), key=str):
        if dev.type not in usage:
            usage[dev.type] = estimate_block_usage(cfg, readback, dev.type)
            log.info(f"{dev.type} block-step memory estimate: " + ", ".join(
                f"{k}={v / 1e6:.0f}M" for k, v in usage[dev.type].items()))
        workers = devices.count(dev) * queues
        per_worker = usage[dev.type]["total"] + (
            WORKER_CONTEXT_BYTES if processes and dev.type == "cuda" else 0)
        limit = device_memory_bytes(dev)
        if limit is not None and per_worker * workers > limit * 0.9:
            raise InvalidOption(
                f"estimated block usage {per_worker / 1e9:.2f} GB x "
                f"{workers} queue(s) exceeds the memory of {dev}, "
                f"{limit / 1e9:.2f} GB; reduce --device-threads, --levels, "
                "--max-device-splats or --device-block-shift")
    return usage[devices[0].type] if devices else {}
