"""The workers and the block step (pipeline/streamer.py's `compute`
action, pipeline/workers.py in a worker process): ms a block of
`device.cpu`, the worker thread's CPU time over the interval that
`block_step_ms` times, the h2d copy and the waits on the card included."""


def read(ctx):
    return ctx.per_block_ms("device.cpu")
