"""The yardstick of the kernels' rooflines: the card's published peaks and
the bytes a kernel must move, worked out from the cell's own inputs and
outputs (never from structures the program builds).

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W power
limit (the same figures as the repository's chip_smoke.py). A card set
below 700 W runs slower under load; the harness reports the card's name
beside every reading and PERF.md gives its power limit.
"""

from __future__ import annotations

#: HBM3 bandwidth, bytes a second.
HBM_RATE = 3.35e12
#: Bytes of one splat as the field kernel reads it: 8 float32.
SPLAT_BYTES = 32


def dense_field_bytes(corners_per_axis: int) -> int:
    """Bytes of one dispatch's dense float32 field."""
    return 4 * corners_per_axis ** 3


def field_bytes(splats: int, dispatches: int, one_field: int) -> int:
    """Bytes the MLS field kernel must move over a job: every splat read
    once, every dispatch's field written once."""
    return SPLAT_BYTES * splats + dispatches * one_field


def bytes_time(nbytes: float) -> float:
    """The least seconds the card needs to move `nbytes`."""
    return nbytes / HBM_RATE
