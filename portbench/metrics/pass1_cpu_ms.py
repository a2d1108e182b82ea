"""The streamer's pass (pipeline/reconstruct.py): ms a job of
`pass1.cpu`, the process's CPU time over `pass1.time`, every thread's,
spanned or not."""


def read(ctx):
    return ctx.per_job_ms("pass1.cpu")
