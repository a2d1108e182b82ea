"""Output chunk identifiers (reference src/chunk_id.h:41-88)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True, order=True)
class ChunkId:
    """Generation number + 3D coordinates of an output chunk. gen numbers are
    assigned in bucket emission order and give a total order for writes."""
    gen: int = 0
    coords: Tuple[int, int, int] = (0, 0, 0)
