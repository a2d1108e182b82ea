"""The weld on the card (`weld_sort_histogram_kernel`,
`weld_sort_pass_kernel` and `weld_group_kernel`, csrc/mesh.cu via
ops/mesh_cuda.py; the packed and raw readbacks) against the weld whole's
bytes bound, in %, over one traced job: the bytes of
portbench/shape_bytes.py::weld_bytes at one job's vertices before and
after the weld (the window's `weld.unwelded` and `weld.welded` counters
over its jobs, which all reconstruct the same cloud), over the card's
HBM rate; against the three kernels' total time in the trace. None where
the program counts no weld shapes."""

from portbench import roofline, shape_bytes

KERNELS = ("weld_sort_histogram_kernel", "weld_sort_pass_kernel",
           "weld_group_kernel")


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.jobs:
        return None
    seconds = sum(t.kernels.get(k, 0.0) for k in KERNELS)
    unwelded, welded = ctx.total("weld.unwelded"), ctx.total("weld.welded")
    if not seconds or not unwelded or welded is None:
        return None
    b = shape_bytes.corners(ctx.field_bytes)
    moved = shape_bytes.weld_bytes(b, unwelded / ctx.jobs, welded / ctx.jobs)
    return 100.0 * roofline.bytes_time(moved) / seconds
