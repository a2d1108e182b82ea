"""Device memory precheck (port of mlsgpu_tpu/pipeline/resources.py, the
reference's resourceUsage/validateDevice, src/mlsgpu_core.cpp:469-518):
estimate one block step's device working set from the configuration and
fail early when the card cannot hold it."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from mlsgpu_tpu.config import ReconstructConfig
from mlsgpu_tpu.utils import logging as log
from mlsgpu_tpu.utils.errors import InvalidOption

F32 = 4
I64 = 8


def estimate_block_usage(cfg: ReconstructConfig) -> Dict[str, int]:
    """Approximate peak device bytes of one block step."""
    b = 1 << cfg.device_shift  # corners of one device dispatch
    cells = (b - 1) ** 3
    n = cfg.max_device_splats
    entries = 8 * n
    usage = {
        "splats": n * (8 * F32 + 1),
        # keys + vals (+ the sort's copies) and the gathered entry rows
        "binning": entries * (2 * I64 * 2 + 8 * F32),
        "field": b ** 3 * F32,
        # dense classification: case code, finite/region/occupied masks and
        # a shifted-corner temporary per cell
        "marching_dense": cells * (I64 + 3 + F32),
        # per-chunk candidate tensors of the face pass (32 rows x 64 corners
        # x K slots x 9 moments), K ~ the per-tile candidate guess
        "faces": 32 * 64 * cfg.tile_candidates * 9 * F32 * 2,
    }
    usage["total"] = sum(usage.values())
    return usage


def device_memory_bytes(device: torch.device) -> Optional[int]:
    """Total memory of a CUDA device; None for the CPU."""
    if device.type != "cuda":
        return None
    _, total = torch.cuda.mem_get_info(device)
    return int(total)


def validate_device(cfg: ReconstructConfig,
                    device: torch.device) -> Dict[str, int]:
    """Estimate and check against the device; raises InvalidOption when the
    block step cannot fit."""
    usage = estimate_block_usage(cfg)
    limit = device_memory_bytes(device)
    log.info("device block-step memory estimate: "
             + ", ".join(f"{k}={v / 1e6:.0f}M" for k, v in usage.items()))
    if limit is not None and usage["total"] > limit * 0.9:
        raise InvalidOption(
            f"estimated block usage {usage['total'] / 1e9:.2f} GB exceeds "
            f"device memory {limit / 1e9:.2f} GB; reduce --levels, "
            "--max-device-splats or --device-block-shift")
    return usage
