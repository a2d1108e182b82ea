"""The host decode (the streamer's `decode` action around
pipeline/reconstruct.py::block_result_to_input): ms a block of
`readback.decodeCpu`, the decode thread's CPU time."""


def read(ctx):
    return ctx.per_block_ms("readback.decodeCpu")
