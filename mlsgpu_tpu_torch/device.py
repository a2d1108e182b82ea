"""Device and precision setup for the port.

All MLS math is FP32. On the card, TF32 would keep ~10 mantissa bits in
matrix products and cuDNN convolutions — catastrophic for the expanded
|x - c|^2 distance form (the JAX package needs Precision.HIGHEST for the
same reason, mlsgpu_tpu/ops/mls.py:128-131) — so both switches are turned
off once, before any device work.
"""

from __future__ import annotations

from typing import List

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


def resolve_devices(name: str, num_devices: int = 0) -> List[torch.device]:
    """The devices a run streams its blocks over (--device, --num-devices).

    'cuda' means every visible card when `num_devices` is 0 and the first
    `num_devices` otherwise (the JAX package's rule for its local devices,
    mlsgpu_tpu/pipeline/streamer.py:52-56); an indexed 'cuda:i' means that
    card alone, and 'cpu' the CPU. Asking for more cards than are visible,
    or for more than one device with 'cpu' or an indexed card, is an error:
    a run never quietly uses fewer devices than it was asked for."""
    num_devices = int(num_devices)
    if num_devices < 0:
        raise InvalidOption("--num-devices must not be negative")
    try:
        indexed = torch.device(name).index is not None
    except RuntimeError as e:
        raise InvalidOption(f"unknown device {name!r}: {e}") from e
    if num_devices > 1 and (indexed or torch.device(name).type == "cpu"):
        raise InvalidOption(
            f"--num-devices {num_devices} with --device {name}: {name} is "
            "one device; pass --device cuda to use several cards")
    dev = resolve_device(name)
    if dev.type != "cuda":
        return [dev]
    visible = torch.cuda.device_count()
    if indexed:
        if dev.index >= visible:
            raise InvalidOption(f"--device {name}: only {visible} card(s) "
                                "visible")
        return [dev]
    if num_devices > visible:
        raise InvalidOption(f"--num-devices {num_devices}: only {visible} "
                            "card(s) visible")
    return [torch.device("cuda", i)
            for i in range(num_devices or visible)]
