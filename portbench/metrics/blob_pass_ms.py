"""The blob pass (pipeline/reconstruct.py, pipeline/blobs.py): ms a job
of `pass0.time`."""


def read(ctx):
    return ctx.per_job_ms("pass0.time")
