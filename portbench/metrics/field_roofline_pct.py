"""The MLS field kernel (csrc/mls_field.cu via ops/mls_cuda.py) against
its bytes bound, in %, over one traced job: each dispatch's dense field
written once in float32, and every splat of the cloud read once at 32
bytes (a dispatch reads the splats it bins; those a splat shares with a
neighbouring block are not counted, which lowers the bound a little),
over the card's HBM rate; against the kernel's total time in the trace.
Operations are not counted: the bound is of bytes alone."""

from portbench import roofline


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    seconds = t.kernels.get("mls_field_kernel")
    dispatches = ctx.traced_launches.get("mls_field")
    if not seconds or not dispatches:
        return None
    moved = roofline.field_bytes(ctx.splats, dispatches, ctx.field_bytes)
    return 100.0 * roofline.bytes_time(moved) / seconds
