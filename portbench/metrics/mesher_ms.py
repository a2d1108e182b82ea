"""The mesher (pipeline/mesher.py): ms a block of `mesher.time`."""


def read(ctx):
    return ctx.per_block_ms("mesher.time")
