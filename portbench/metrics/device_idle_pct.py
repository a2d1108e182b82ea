"""The card's idle share of one traced job: one less the union of its
kernel, copy and set intervals over the job's wall time, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or t.wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
