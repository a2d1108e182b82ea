"""The workers and the block step (pipeline/workers.py, ops/block.py):
ms a block of `device.time`, the worker's host clock around its step and
the step's copy to the card (not the card's own time)."""


def read(ctx):
    return ctx.per_block_ms("device.time")
