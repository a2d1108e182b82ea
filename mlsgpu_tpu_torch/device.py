"""Device and precision setup for the port.

All MLS math is FP32. On the card, TF32 would keep ~10 mantissa bits in
matrix products and cuDNN convolutions — catastrophic for the expanded
|x - c|^2 distance form (the JAX package needs Precision.HIGHEST for the
same reason, mlsgpu_tpu/ops/mls.py:128-131) — so both switches are turned
off once, before any device work.
"""

from __future__ import annotations

import torch

from mlsgpu_tpu_torch.utils.errors import InvalidOption


def set_precision() -> None:
    """Full-FP32 matmul and convolution (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(name: str) -> torch.device:
    """The torch device a run uses. 'cuda' requires a visible card: a
    missing GPU is an error, never a silent switch to the CPU."""
    try:
        dev = torch.device(name)
    except RuntimeError as e:
        raise InvalidOption(f"unknown device {name!r}: {e}") from e
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise InvalidOption(
                "CUDA device requested but torch.cuda.is_available() is "
                "false; pass --device cpu to run the plain PyTorch path on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise InvalidOption(f"unsupported device {name!r} (cuda or cpu)")
    set_precision()
    return dev
