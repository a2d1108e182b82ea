"""The classification kernel (`march_classify_kernel`, csrc/marching.cu
via ops/marching_cuda.py; every readback's first marching kernel) against
its bytes bound, in %, over one traced job: each launch the dispatch's
b^3 float32 field read once, an 8-byte record a tile and a 16-byte record
a row segment written once (portbench/shape_bytes.py), over the card's HBM
rate; against the kernel's total time in the trace. Tiled classification
(above 256 corners an axis) reads only its candidate tiles' corners and
is held to the same bound. Operations are not counted."""

from portbench import roofline, shape_bytes


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    seconds = t.kernels.get("march_classify_kernel")
    launched = ctx.traced_launches.get("march_classify")
    if not seconds or not launched:
        return None
    b = shape_bytes.corners(ctx.field_bytes)
    moved = launched * shape_bytes.classify_bytes(b)
    return 100.0 * roofline.bytes_time(moved) / seconds
