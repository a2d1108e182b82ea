"""The mesher (the `mesher` action of pipeline/reconstruct.py, around
pipeline/mesher.py's add): ms a block of `mesher.cpu`, the mesher
thread's CPU time."""


def read(ctx):
    return ctx.per_block_ms("mesher.cpu")
