"""The host decode (pipeline/reconstruct.py::block_result_to_input, the
native library): ms a block of `readback.decode`."""


def read(ctx):
    return ctx.per_block_ms("readback.decode")
