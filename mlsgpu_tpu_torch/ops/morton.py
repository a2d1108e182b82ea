"""3-D Morton (Z-order) codes on int64 tensors, 10 bits per axis (port of
the jnp half of mlsgpu_tpu/ops/morton.py). Codes are z-major (z bits above
y above x). int64 stands in for the JAX package's uint32: the values are
identical and torch's uint32 support is partial."""

from __future__ import annotations

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
