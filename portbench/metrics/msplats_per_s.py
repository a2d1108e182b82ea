"""Reconstruction throughput: all splats of all jobs finished in the
window over the window's time, in millions a second."""


def read(ctx):
    if not ctx.jobs or ctx.window_s <= 0:
        return None
    return ctx.jobs * ctx.splats / ctx.window_s / 1e6
