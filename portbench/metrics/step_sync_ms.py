"""The block step's host waits on the card (the `sync` actions inside the
worker's `compute`: the codes path's one, the totals' stream
synchronisation in ops/marching_cuda.py::classify): ms a block of
`device.syncWait`, wall time."""


def read(ctx):
    return ctx.per_block_ms("device.syncWait")
