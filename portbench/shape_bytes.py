"""The bytes two of the card's stages must move, worked out from a block's
corners and the shapes the program counts for each block (its
`march.*` and `weld.*` counters, pipeline/workers.py::count_block), by
the arithmetic of the repository's chip_smoke.py (`marching_bound`,
`mesh_bound`). Each input is read once and each output written once;
integer work is not counted. portbench/roofline.py gives the card's
rate."""

from __future__ import annotations

#: Cells an axis of a marching tile, and tiles an axis of a classify row
#: segment (mlsgpu_tpu_torch/ops/marching.py, ops/marching_cuda.py).
TILE = 8
ROW_TILES = 8


def corners(field_bytes: int) -> int:
    """Corners an axis of a dispatch whose dense float32 field takes
    `field_bytes` (roofline.dense_field_bytes)."""
    b = round((field_bytes / 4) ** (1.0 / 3.0))
    if 4 * b ** 3 != field_bytes:
        raise ValueError(f"{field_bytes} bytes is no cube of float32")
    return b


def classify_bytes(b: int) -> int:
    """One classification of a (b, b, b) field, dense or tiled: the field
    in, an 8-byte record a tile and a 16-byte record a row segment out."""
    g = -(-(b - 1) // TILE)
    segments = g * g * -(-g // ROW_TILES)
    return 4 * b ** 3 + 8 * g ** 3 + 16 * segments


def weld_key_bytes(b: int) -> int:
    """Bytes of a compact weld key of a block of b corners an axis: three
    axes of the doubled coordinates (up to 2 (b - 1)) and the external
    flag, in 4 bytes up to 32 bits, else 8."""
    bits = 3 * (2 * (b - 1)).bit_length() + 1
    return 4 if bits <= 32 else 8


def weld_bytes(b: int, unwelded: float, welded: float) -> float:
    """The weld whole (its sort and group kernels) of `unwelded` vertices
    into `welded`: the compact keys in at their sort width, a welded
    vertex's 3 floats and 2 key halves in and out (20 bytes each way), an
    int32 remap a vertex out. Linear in the counts, so a job's totals give
    the sum of its blocks' bytes."""
    return (weld_key_bytes(b) + 4) * unwelded + 2 * 20 * welded
