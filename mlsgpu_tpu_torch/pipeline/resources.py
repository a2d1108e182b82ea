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

from mlsgpu_tpu_torch.ops.binning_cuda import sort_scratch_words
from mlsgpu_tpu_torch.ops.marching import TILE, TILED_ABOVE
from mlsgpu_tpu_torch.ops.marching_cuda import scan_state_words, segment_rows
from mlsgpu_tpu_torch.ops.mesh_cuda import (WELD_COUNTS, axis_bits,
                                            key_bits, sort_key_bytes,
                                            weld_scratch_words,
                                            weld_work_words)
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


def _block(nbytes: int) -> int:
    """The most bytes PyTorch's CUDA caching allocator counts for a buffer
    of `nbytes`: a multiple of its 512-byte block and, above 1 MiB, up to
    1 MiB more (it hands out a cached block whole when splitting it would
    leave 1 MiB or less)."""
    b = -(-nbytes // 512) * 512
    return b + (1 << 20 if b > 1 << 20 else 0)


def seam_local_reserve(device: torch.device, attributes=None) -> int:
    """Device memory the driver reserves for the seam kernels' local
    memory in each process that launches them: their larger local size a
    thread times every thread the card can hold, from
    `attributes(device)` (by default seam_cuda.kernel_attributes: read
    from the kernel library and the card at run time, so the calling
    process builds and loads that library, also when only its worker
    processes launch the kernels)."""
    if attributes is None:
        from mlsgpu_tpu_torch.ops import seam_cuda
        attributes = seam_cuda.kernel_attributes
    a = attributes(device)
    return (int(a["local_bytes"]) * int(a["threads_per_multiprocessor"])
            * int(a["multiprocessors"]))


def estimate_block_usage(cfg: ReconstructConfig, readback: str = "codes",
                         device_type: str = "cuda",
                         seam_reserve: int = 0) -> Dict[str, int]:
    """Approximate peak device bytes of one block step in a readback mode
    ("codes", "packed" or "raw") on a device of `device_type` ("cuda": the
    kernels' path; "cpu": the plain versions'). `seam_reserve`: the seam
    kernels' local memory reserve on the card (seam_local_reserve). On
    the card binning holds the radix sort's buffers, then the gather's
    (`binning`; torch.sort's on the CPU), and every readback marches and
    packs in kernels: `marching_kernels` counts the codes readback's
    buffers, and the packed and raw readbacks' with `weld_kernels` and
    `pack_kernels`; the CPU marches, welds and packs with the plain
    versions (`marching_dense` or `marching_tiled`, `emission`, `mesh`,
    `weld`, `pack`)."""
    b = 1 << cfg.device_shift  # corners of one device dispatch
    cells = (b - 1) ** 3
    n = cfg.max_device_splats
    entries = 8 * n
    usage = {
        "splats": n * (8 * F32 + 1),
        "field": b ** 3 * F32,
    }
    if device_type == "cuda":
        # the kernel path (ops/binning_cuda.py): the radix sort holds the
        # int64 keys, the sorted keys and permutation, the int32 keys and
        # indices of the passes between, and its scratch (each pass's
        # histogram, ticket and a status word a (tile, digit)); then the
        # keys and the sort's buffers are freed, and the gather holds the
        # sorted keys, the permutation, the row indices and the gathered
        # rows. Each buffer as the caching allocator may count it.
        min_s = cfg.subsampling
        max_s = cfg.levels + cfg.subsampling - 1
        sort = (3 * _block(entries * I64) + _block(entries * 2 * 4)
                + _block(I64 * sort_scratch_words(entries, min_s, max_s)))
        gather = 3 * _block(entries * I64) + _block(entries * 8 * F32)
        usage["binning"] = max(sort, gather)
        # the seam kernels write the field in place and allocate nothing:
        # only the driver's reserve for their local memory
        usage["faces"] = int(seam_reserve)
    else:
        # an entry's int64 key, sorted key, sort permutation and row index
        # and its gathered row; torch.sort holds at most 6 int64 an entry
        # (keys and indices in, sorted out, its own alternate buffers)
        usage["binning"] = entries * (2 * I64 * 2 + 8 * F32)
        # per-chunk tensors of the face pass over 32 rows x 64 corners x K
        # slots, K ~ the per-tile candidate guess: the weighted moments
        # (9 f32) and the first level of their pairwise tree, the
        # per-corner sort's order (i64) and key (u8), the weights, their
        # sorted copy and the distance temporaries (4 f32), the reach mask
        # (u8)
        usage["faces"] = 32 * 64 * cfg.tile_candidates * (
            2 * 9 * F32 + I64 + 4 * F32 + 2)
    # Per occupied cell, per emitted vertex (<= 13 per cell, ~4 on a
    # surface).
    occ = int(cells * SURFACE_CELL_SHARE)
    verts = 4 * occ
    g = -(-(b - 1) // TILE)
    if device_type == "cuda" and readback == "codes":
        # the marching kernels' buffers (ops/marching_cuda.py), nothing
        # more: an 8-byte record a tile, a 16-byte record a row segment of
        # 8 tiles, the scan's state (its ticket and a status word a total
        # a tile of segments), the occupied-tile list (4 int32 a tile), the
        # totals, and the codes image (an id word and a code byte an
        # occupied cell, a t16 halfword a vertex)
        usage["marching_kernels"] = (
            g ** 3 * (8 + 16) + segment_rows(g) * 16
            + scan_state_words(g) * I64 + 5 * I64
            + 4 * (occ + -(-occ // 4) + -(-verts // 2)))
    elif device_type == "cuda":
        # the mesh readbacks' kernels (ops/mesh_cuda.py), each buffer as
        # the caching allocator may count it, at most 3 triangle indices a
        # vertex (36 a cell of 13 at most): classify's and the scan's
        # buffers (as codes'), the emission's vertices (3 f32), key halves
        # (2 int32), compact sort keys (4 bytes up to 32 key bits, else 8)
        # and int32 indices; the
        # weld's work buffers (the passes' keys and indices) and scratch,
        # the welded vertices and key halves, the remap and the totals;
        # then the packed image (u32 indices at most, 4
        # u16 words a vertex) or raw's remapped int32 triangles
        indices = 3 * verts
        bits = key_bits(axis_bits(b))
        usage["marching_kernels"] = (
            _block(g ** 3 * 8) + _block(segment_rows(g) * 16)
            + _block(scan_state_words(g) * I64) + _block(g ** 3 * 16)
            + _block(5 * I64) + _block(verts * 3 * F32)
            + 2 * _block(verts * 4) + _block(verts * sort_key_bytes(bits))
            + _block(indices * 4))
        usage["weld_kernels"] = (
            _block(4 * weld_work_words(verts, bits))
            + _block(I64 * weld_scratch_words(verts, bits))
            + _block(verts * 3 * F32) + 3 * _block(verts * 4)
            + _block(WELD_COUNTS * I64))
        usage["pack_kernels"] = _block(
            4 * (indices + 2 * verts + 1) if readback == "packed"
            else 4 * indices)
    else:
        if b > TILED_ABOVE:
            # tiled classification: the NaN-padded field copy, the
            # candidate tiles' (tiles, 9, 9, 9) halo gather, and per
            # candidate cell a case code and masks
            tiles = int(-(-(b - 1) // TILE) ** 3 * CANDIDATE_TILE_SHARE)
            usage["marching_tiled"] = ((b + TILE) ** 3 * F32
                                       + tiles * (TILE + 1) ** 3 * F32
                                       + tiles * TILE ** 3 * (I64 + 3))
        else:
            # dense classification: case code, finite/region/occupied
            # masks and a shifted-corner temporary per cell
            usage["marching_dense"] = cells * (I64 + 3 + F32)
        # Emission, per occupied cell: code, (x, y, z), 8 corner isos; per
        # emitted vertex its producer, rank, edge and t.
        usage["emission"] = (occ * (4 * I64 + 8 * F32)
                             + verts * (4 * I64 + F32))
    if readback != "codes" and device_type != "cuda":
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
        if str(dev) not in usage:
            reserve = seam_local_reserve(dev) if dev.type == "cuda" else 0
            usage[str(dev)] = estimate_block_usage(cfg, readback, dev.type,
                                                   reserve)
            log.info(f"{dev} block-step memory estimate: " + ", ".join(
                f"{k}={v / 1e6:.0f}M" for k, v in usage[str(dev)].items()))
        workers = devices.count(dev) * queues
        per_worker = usage[str(dev)]["total"] + (
            WORKER_CONTEXT_BYTES if processes and dev.type == "cuda" else 0)
        limit = device_memory_bytes(dev)
        if limit is not None and per_worker * workers > limit * 0.9:
            raise InvalidOption(
                f"estimated block usage {per_worker / 1e9:.2f} GB x "
                f"{workers} queue(s) exceeds the memory of {dev}, "
                f"{limit / 1e9:.2f} GB; reduce --device-threads, --levels, "
                "--max-device-splats or --device-block-shift")
    return usage[str(devices[0])] if devices else {}
