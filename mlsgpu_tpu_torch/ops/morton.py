"""3-D Morton (Z-order) codes (port of mlsgpu_tpu/ops/morton.py): on int64
tensors with 10 bits per axis (int64 stands in for the JAX package's uint32:
the values are identical and torch's uint32 support is partial), and on
uint64 numpy arrays with 21 bits per axis. Codes are z-major (z bits above
y above x)."""

from __future__ import annotations

import numpy as np
import torch


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so there are two zero bits between each."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _compact1by2(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0x9249249
    x = (x | (x >> 2)) & 0x30C30C3
    x = (x | (x >> 4)) & 0x300F00F
    x = (x | (x >> 8)) & 0x30000FF
    x = (x | (x >> 16)) & 0x3FF
    return x


def encode(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Interleave up to 10 bits per axis into a Morton code (z-major)."""
    return _part1by2(x) | (_part1by2(y) << 1) | (_part1by2(z) << 2)


def decode(code: torch.Tensor):
    code = code.to(torch.int64)
    return (_compact1by2(code), _compact1by2(code >> 1),
            _compact1by2(code >> 2))


# numpy, uint64, 21 bits per axis (port of the numpy half of
# mlsgpu_tpu/ops/morton.py): sparse bucketing's microblock codes.

def _part1by2_u64(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so there are two zero bits between each."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def _compact1by2_u64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x1249249249249249)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return x


def encode_np(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave up to 21 bits per axis into a uint64 Morton code (z-major)."""
    return (_part1by2_u64(np.asarray(x))
            | (_part1by2_u64(np.asarray(y)) << np.uint64(1))
            | (_part1by2_u64(np.asarray(z)) << np.uint64(2)))


def decode_np(code: np.ndarray):
    code = np.asarray(code, dtype=np.uint64)
    return (_compact1by2_u64(code).astype(np.int64),
            _compact1by2_u64(code >> np.uint64(1)).astype(np.int64),
            _compact1by2_u64(code >> np.uint64(2)).astype(np.int64))
